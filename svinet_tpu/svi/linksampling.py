"""LinkSampling engine — the recommended inference mode.

JAX re-design of the reference's LinkSampling engine
(reference: src/linksampling.cc:557-790). One iteration = one full sweep
over the training links with a closed-form single-shot phi per link:

  phi_k  ~  exp( Elogpi[p,k] + Elogpi[q,k] + Elogbeta[k,0] )   (softmax)

Sufficient statistics (reference hot loop, src/linksampling.cc:605-725):
  gamma_hat[p] += phi,  gamma_hat[q] += phi
  lambda0_hat[k] += 2 phi_k,   sum_k += 2 phi_k

Nonlink contributions enter in expectation via per-node mean indicators
m_p = (gamma_hat_p - alpha) / deg_p scaled by (n - deg_p - 1)
(reference: compute_mean_indicators, src/linksampling.cc:526-545), and
lambda1_hat gets the cross-moment correction s1^2 - s2 - s3
(reference: src/linksampling.cc:731-749). An annealing phase scales each
community's column by ones/sum_k until the first validation plateau
(reference: src/linksampling.cc:541-542, 1036-1043).

The reference's per-link C++ loop becomes a single jitted XLA program per
sweep: a blocked lax.scan over padded edge blocks — gather of Elogpi rows,
row-softmax, scatter-add of the block's statistics. The data-dependent
sparsity tricks (converged-node freezing, active-k pruning,
src/linksampling.cc:622-664) are accelerations of the same math; here
they are opt-in flags and the dense vectorized path is the default.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from svinet_tpu.config import Config
from svinet_tpu.graph import Network
from svinet_tpu.ops.expectations import dirichlet_expectation
from svinet_tpu.ops.edges import pad_edges
from svinet_tpu.svi.base import EngineBase
from svinet_tpu.svi.sweep_math import (
    LSConsts, phi_pass, mean_indicator_update, s3_pass, finish_lambda,
    converged_of, fused_phi_s3_pass,
)
from svinet_tpu.io.writers import load_model


def _sweep_body(gamma, lam, edges, mask, deg, consts: LSConsts,
                annealing, num_blocks: int, freeze: bool = False,
                bf16: bool = False, conv=None):
    # Converged-node freezing (reference fast path,
    # src/linksampling.cc:618-631): implemented via the `conv` argument of
    # phi_pass/s3_pass — STICKY flags carried by the engine/loops
    # (converged_of(prev=...), matching the reference's never-cleared
    # _converged). It adds two int row-gathers per edge and slightly
    # worsened ca-AstroPh heldout nshol (-0.0099 vs -0.0088), so it is
    # OFF by default (its speed is to be measured again on the GPU).
    # Engagement requires nodes to genuinely reach
    # ONE active column: on assort-75-4 that happens at K=4 (~30/75
    # nodes frozen by iter 40, test_freeze_sticky_never_thaws) but NOT
    # at K=20, where nodes keep ~3 active columns indefinitely — at
    # overshot K the consolidation force is `-prune`/annealing, not
    # freezing. Exposed as `-freeze`.
    elogpi = dirichlet_expectation(gamma)
    if bf16:
        # -bf16: store the gathered rows half-width; phi_pass casts back
        # to f32 AFTER the gather and accumulates in f32
        elogpi = elogpi.astype(jnp.bfloat16)
    elogbeta = dirichlet_expectation(lam)
    if freeze and conv is None:
        conv = converged_of(gamma, consts.alpha)
    gacc, sumk = phi_pass(elogpi, elogbeta[:, 0], edges, mask, num_blocks,
                          conv)
    gnext, mphi, s1, s2, lam0 = mean_indicator_update(
        gacc, sumk, deg, consts, annealing)
    s3 = s3_pass(mphi.astype(jnp.bfloat16) if bf16 else mphi,
                 edges, mask, num_blocks, conv)
    return gnext, finish_lambda(s1, s2, s3, lam0, consts)


@functools.partial(jax.jit, donate_argnums=(0, 1),
                   static_argnames=("num_blocks", "freeze", "bf16"))
def linksampling_sweep(gamma, lam, edges, mask, deg, consts: LSConsts,
                       annealing, num_blocks: int, freeze: bool = False,
                       bf16: bool = False, conv=None):
    """One full sweep over the training links. Pure function of the state.

    edges: (Ep,2) int32 padded; mask: (Ep,) f32; deg: (n,) f32 training degree.
    annealing: f32 scalar in {0,1}.
    conv: optional (n,) int32 sticky converged flags (-freeze; the engine
    owns the sticky update between calls, see LinkSampling._sticky_conv).
    """
    return _sweep_body(gamma, lam, edges, mask, deg, consts, annealing,
                       num_blocks, freeze, bf16, conv)


@functools.partial(jax.jit, donate_argnums=(0, 1),
                   static_argnames=("num_blocks", "n_sweeps", "freeze",
                                    "bf16"))
def linksampling_multi_sweep(gamma, lam, edges, mask, deg,
                             consts: LSConsts, annealing,
                             num_blocks: int, n_sweeps: int,
                             freeze: bool = False, bf16: bool = False,
                             conv=None):
    """n_sweeps full sweeps fused into ONE device program.

    Between report boundaries nothing on the host needs the intermediate
    state, so the sweeps run back-to-back on device — one host round trip
    per report interval instead of per sweep.

    With -freeze, conv carries the STICKY converged flags through the
    loop (reference: _converged assigned by prune() after each sweep and
    never cleared, src/linksampling.cc:472-473); returns (g, l, conv)
    when conv is given, (g, l) otherwise."""
    def body(_, state):
        g, l, cv = state
        gn, ln = _sweep_body(g, l, edges, mask, deg, consts, annealing,
                             num_blocks, freeze, bf16, cv)
        cvn = (converged_of(gn, consts.alpha, cv)
               if freeze and cv is not None else cv)
        return gn, ln, cvn
    g, l, cv = jax.lax.fori_loop(0, n_sweeps, body, (gamma, lam, conv))
    return (g, l) if conv is None else (g, l, cv)


def _fused_sweep_body(gamma, lam, mphi, edges, mask, deg,
                      consts: LSConsts, annealing, num_blocks: int,
                      bf16: bool = False):
    """-fuse-s3 sweep: one edge pass over packed [Elogpi | mphi_prev]
    rows computes phi stats AND the (one-sweep-lagged) s3 cross-moment
    — two fewer row gathers per edge. Carries mphi between sweeps. With
    -bf16 the packed
    rows are stored half-width; the pass casts back to f32 after the
    gather and accumulates in f32."""
    elogpi = dirichlet_expectation(gamma)
    elogbeta = dirichlet_expectation(lam)
    packed = jnp.concatenate([elogpi, mphi], axis=1)
    if bf16:
        packed = packed.astype(jnp.bfloat16)
    gacc, sumk, s3 = fused_phi_s3_pass(packed, elogbeta[:, 0], edges,
                                       mask, num_blocks)
    gnext, mphi_new, s1, s2, lam0 = mean_indicator_update(
        gacc, sumk, deg, consts, annealing)
    return gnext, finish_lambda(s1, s2, s3, lam0, consts), mphi_new


@functools.partial(jax.jit, donate_argnums=(0, 1, 2),
                   static_argnames=("num_blocks", "n_sweeps", "bf16"))
def linksampling_fused_multi_sweep(gamma, lam, mphi, edges, mask, deg,
                                   consts: LSConsts, annealing,
                                   num_blocks: int, n_sweeps: int,
                                   bf16: bool = False):
    """n_sweeps -fuse-s3 sweeps fused into one device program."""
    def body(_, state):
        g, l, m = state
        return _fused_sweep_body(g, l, m, edges, mask, deg, consts,
                                 annealing, num_blocks, bf16)
    return jax.lax.fori_loop(0, n_sweeps, body, (gamma, lam, mphi))


@functools.partial(jax.jit, donate_argnums=(0, 1, 2),
                   static_argnames=("num_blocks", "n_sweeps", "bf16",
                                    "ho_blocks"))
def linksampling_fused_multi_sweep_ho(gamma, lam, mphi, edges, mask, deg,
                                      consts: LSConsts, annealing,
                                      ho_pairs, ho_y, ho_w, eps,
                                      num_blocks: int, n_sweeps: int,
                                      ho_blocks: int, bf16: bool = False):
    """Fused multi-sweep + the validation heldout sums computed on the
    FINAL state as the tail of the same program: a report boundary costs
    one device round trip instead of sweep-then-eval."""
    from svinet_tpu.evals.likelihood import heldout_sums_blocked

    def body(_, state):
        g, l, m = state
        return _fused_sweep_body(g, l, m, edges, mask, deg, consts,
                                 annealing, num_blocks, bf16)
    g, l, m = jax.lax.fori_loop(0, n_sweeps, body, (gamma, lam, mphi))
    sums = heldout_sums_blocked(g, l, ho_pairs, ho_y, ho_w, eps,
                                ho_blocks)
    return g, l, m, sums


@functools.partial(jax.jit, donate_argnums=(0, 1),
                   static_argnames=("num_blocks", "r", "n_batches",
                                    "ho_blocks", "bf16", "fused"))
def linksampling_sweep_ho_trace(gamma, lam, mphi, edges, mask, deg,
                                consts: LSConsts, annealing,
                                ho_pairs, ho_y, ho_w, eps,
                                num_blocks: int, r: int, n_batches: int,
                                ho_blocks: int, bf16: bool = False,
                                fused: bool = False):
    """-report-batch: n_batches REPORT BOUNDARIES per device dispatch,
    each r sweeps apart, returning the six heldout sums evaluated at
    EVERY boundary state — a (n_batches, 6) trace. The host replays the
    rows through the normal report path, so heldout.txt/max.txt and the
    stopping rule keep their exact per-boundary values while the
    dispatch count drops by n_batches.
    Costs: annealing/stop decisions replay AFTER the batch computed, so
    a mid-batch annealing flip or stop lands up to n_batches-1 sweeps
    late (the extra sweeps only converge the state further). fused
    selects the -fuse-s3 body (mphi carried; pass zeros otherwise)."""
    from svinet_tpu.evals.likelihood import heldout_sums_blocked

    def batch(state, _):
        g, l, m = state
        def body(_, st):
            gg, ll, mm = st
            if fused:
                gn, ln, mn = _fused_sweep_body(
                    gg, ll, mm, edges, mask, deg, consts, annealing,
                    num_blocks, bf16)
            else:
                gn, ln = _sweep_body(gg, ll, edges, mask, deg, consts,
                                     annealing, num_blocks, False, bf16)
                mn = mm
            return gn, ln, mn
        g, l, m = jax.lax.fori_loop(0, r, body, (g, l, m))
        sums = heldout_sums_blocked(g, l, ho_pairs, ho_y, ho_w, eps,
                                    ho_blocks)
        return (g, l, m), sums

    (g, l, m), trace = jax.lax.scan(batch, (gamma, lam, mphi), None,
                                    length=n_batches)
    return g, l, m, trace


@functools.partial(jax.jit, donate_argnums=(0, 1),
                   static_argnames=("num_blocks", "n_sweeps", "freeze",
                                    "bf16", "ho_blocks"))
def linksampling_multi_sweep_ho(gamma, lam, edges, mask, deg,
                                consts: LSConsts, annealing,
                                ho_pairs, ho_y, ho_w, eps,
                                num_blocks: int, n_sweeps: int,
                                ho_blocks: int, freeze: bool = False,
                                bf16: bool = False, conv=None):
    """Unfused multi-sweep with the heldout-sums tail (see above).
    Returns (g, l, sums) — plus the sticky conv flags when given."""
    from svinet_tpu.evals.likelihood import heldout_sums_blocked

    def body(_, state):
        g, l, cv = state
        gn, ln = _sweep_body(g, l, edges, mask, deg, consts, annealing,
                             num_blocks, freeze, bf16, cv)
        cvn = (converged_of(gn, consts.alpha, cv)
               if freeze and cv is not None else cv)
        return gn, ln, cvn
    g, l, cv = jax.lax.fori_loop(0, n_sweeps, body, (gamma, lam, conv))
    sums = heldout_sums_blocked(g, l, ho_pairs, ho_y, ho_w, eps,
                                ho_blocks)
    return (g, l, sums) if conv is None else (g, l, sums, cv)


@functools.partial(jax.jit, donate_argnums=(0, 1, 2),
                   static_argnames=("num_blocks", "n_sweeps", "W",
                                    "ho_blocks"))
def linksampling_sparse_multi_sweep(gamma, lam, mphi, edges, mask, deg,
                                    consts: LSConsts, annealing,
                                    ho_pairs, ho_y, ho_w, eps,
                                    num_blocks: int, n_sweeps: int,
                                    W: int, ho_blocks: int):
    """n_sweeps top-W union sweeps (-sparse-w) fused into one device
    program, with the heldout-sums tail when ho_blocks > 0 (see
    sweep_math.sparse_union_sweep_body for the sparse semantics)."""
    from svinet_tpu.svi.sweep_math import sparse_union_sweep_body

    def body(_, state):
        g, l, m = state
        return sparse_union_sweep_body(g, l, m, edges, mask, deg,
                                       consts, annealing, num_blocks, W)
    g, l, m = jax.lax.fori_loop(0, n_sweeps, body, (gamma, lam, mphi))
    if ho_blocks:
        from svinet_tpu.evals.likelihood import heldout_sums_blocked
        return g, l, m, heldout_sums_blocked(g, l, ho_pairs, ho_y, ho_w,
                                             eps, ho_blocks)
    return g, l, m


@jax.jit
def _active_counts(gamma, alpha):
    """Per-node count of communities with gamma - alpha >= 1 (the
    reference's convergence test, src/linksampling.cc:456-475)."""
    return (gamma - alpha >= 1.0).sum(axis=1).astype(jnp.int32)


# ---------------------------------------------------------------------
# Active-K column compaction (-prune): the dense-layout form of the
# reference's active-community pruning (src/linksampling.cc:634-664). The
# reference computes per-pair phi over the union of the endpoints'
# active-k lists; data-dependent per-pair widths do not fit XLA's static
# shapes, so instead the
# GLOBAL active column set (any node with gamma - alpha >= 1 — the same
# per-node criterion, src/linksampling.cc:461-466) is gathered into a
# compacted (n, K_pad) layout once per report interval and the identical
# sweep runs at the narrow width. Inactive columns sit at (alpha, eta),
# exactly where a pruned reference sweep leaves them, so expansion at
# the next report boundary is lossless.

@jax.jit
def _active_cols(gamma, alpha):
    """(K,) bool: column k is active when ANY node has gamma-alpha >= 1."""
    return (gamma - alpha >= 1.0).any(axis=0)


@functools.partial(jax.jit, static_argnames=("kpad",))
def compact_columns(gamma, lam, idx, colmask, alpha, eta, kpad: int):
    """Gather the active columns (idx, padded with out-of-range K) into
    (n, kpad) / (kpad, 2); padded slots get (alpha, eta)."""
    gc = jnp.take(gamma, idx, axis=1, mode="clip")
    lc = jnp.take(lam, idx, axis=0, mode="clip")
    gc = jnp.where(colmask[None, :] > 0, gc, alpha)
    lc = jnp.where(colmask[:, None] > 0, lc, eta[None, :])
    return gc, lc


@functools.partial(jax.jit, static_argnames=("k",))
def expand_columns(gamma_c, lam_c, idx, alpha, eta, k: int):
    """Scatter compacted columns back to full width K; every non-active
    column is (alpha, eta) (the pruned sweep's fixed point for them).
    Padded idx entries are K (out of range) and drop on scatter."""
    n = gamma_c.shape[0]
    gamma = jnp.full((n, k), alpha, gamma_c.dtype)
    lam = jnp.broadcast_to(eta[None, :], (k, 2)).astype(lam_c.dtype)
    gamma = gamma.at[:, idx].set(gamma_c, mode="drop")
    lam = lam.at[idx, :].set(lam_c, mode="drop")
    return gamma, lam


@functools.partial(jax.jit, donate_argnums=(0, 1),
                   static_argnames=("num_blocks", "n_sweeps", "freeze"))
def linksampling_compact_multi_sweep(gamma_c, lam_c, edges, mask, deg,
                                     consts: LSConsts, rest, colmask,
                                     num_blocks: int, n_sweeps: int,
                                     freeze: bool = False, conv=None):
    from svinet_tpu.svi.sweep_math import compact_sweep_body

    def body(_, state):
        g, l, cv = state
        gn, ln = compact_sweep_body(g, l, edges, mask, deg, consts, rest,
                                    colmask, num_blocks, freeze, cv)
        cvn = (converged_of(gn, consts.alpha, cv)
               if freeze and cv is not None else cv)
        return gn, ln, cvn
    g, l, cv = jax.lax.fori_loop(0, n_sweeps, body,
                                 (gamma_c, lam_c, conv))
    return (g, l) if conv is None else (g, l, cv)


@functools.partial(jax.jit, donate_argnums=(0, 1, 2),
                   static_argnames=("num_blocks", "n_sweeps"))
def linksampling_compact_fused_multi_sweep(gamma_c, lam_c, mphi_c, edges,
                                           mask, deg, consts: LSConsts,
                                           rest, colmask,
                                           num_blocks: int, n_sweeps: int):
    from svinet_tpu.svi.sweep_math import compact_fused_sweep_body

    def body(_, state):
        g, l, m = state
        return compact_fused_sweep_body(g, l, m, edges, mask, deg, consts,
                                        rest, colmask, num_blocks)
    return jax.lax.fori_loop(0, n_sweeps, body, (gamma_c, lam_c, mphi_c))


def init_gamma_from_communities(members, deg: np.ndarray, n: int, k: int,
                                alpha: float) -> np.ndarray:
    """-init-communities: gamma_p = alpha + deg_p * phi_p where phi_p is
    the normalized membership vector (alpha everywhere + n/|memberships|
    at each of p's initial communities; reference:
    LinkSampling::init_gamma_external, src/linksampling.cc:403-453).
    Community ids >= k are ignored (the reference logs and overruns)."""
    phi = np.full((n, k), alpha)
    for p, comms in enumerate(members):
        cs = [c for c in comms if c < k]
        if cs:
            phi[p, cs] += float(n) / len(comms)
    phi /= phi.sum(axis=1, keepdims=True)
    return alpha + deg[:, None] * phi


@functools.partial(jax.jit, static_argnames=("n", "k", "num_blocks"))
def init_gamma_from_links_device(key, edges, mask, n: int, k: int,
                                 alpha, num_blocks: int):
    """Device equivalent of init_gamma_from_links for edge sets where the
    host (E,K) phi matrix would not fit (the n=1M/k=500 stretch needs
    40 GB of host RAM for it): a scan over the padded edge blocks draws
    each block's normalized-uniform phi on device and scatter-adds it
    into both endpoint rows (reference: LinkSampling::init_gamma2,
    src/linksampling.cc:374-401)."""
    keys = jax.random.split(key, num_blocks)
    eb = edges.reshape(num_blocks, -1, 2)
    mb = mask.reshape(num_blocks, -1)

    def body(gamma, xs):
        blk, msk, kk = xs
        phi = jax.random.uniform(kk, (blk.shape[0], k), jnp.float32)
        phi = phi / phi.sum(axis=1, keepdims=True) * msk[:, None]
        gamma = gamma.at[blk[:, 0]].add(phi)
        gamma = gamma.at[blk[:, 1]].add(phi)
        return gamma, None

    gamma, _ = jax.lax.scan(body, jnp.zeros((n, k), jnp.float32),
                            (eb, mb, keys))
    empty = gamma.sum(axis=1, keepdims=True) == 0
    return jnp.where(empty, alpha, gamma)


def init_gamma_from_links(rng: np.random.Generator, edges: np.ndarray,
                          n: int, k: int, alpha: float) -> np.ndarray:
    """Random per-link phi added to both endpoints
    (reference: LinkSampling::init_gamma2, src/linksampling.cc:374-401).
    Rows without any link fall back to alpha to keep digamma finite."""
    phi = rng.uniform(size=(len(edges), k))
    phi /= phi.sum(axis=1, keepdims=True)
    gamma = np.zeros((n, k), np.float64)
    np.add.at(gamma, edges[:, 0], phi)
    np.add.at(gamma, edges[:, 1], phi)
    empty = gamma.sum(axis=1) == 0
    gamma[empty] = alpha
    return gamma


class LinkSampling(EngineBase):
    """Host driver: owns the annealing phase and the device state; file
    output, stopping, and community logging live in EngineBase."""

    writes_own_timefile = True   # per-chunk rows in _infer_loop
    stop_min_iter = 10           # guard iter > 10 (src/linksampling.cc:1008)
    stop_plateau_why = 100       # (src/linksampling.cc:1013)
    # the annealing decision runs AFTER super().report(); defer the
    # periodic-checkpoint/SIGTERM hooks to the end of OUR report() so a
    # checkpoint never snapshots a mid-report state (stopper updated,
    # annealing history not yet)
    defer_report_hooks = True
    # at a report boundary self.iteration == just-completed sweep j
    # (_infer_loop advances to j+1 only after report()), so boundary
    # checkpoints store j+1 — unlike the pre-incrementing minibatch loops
    ckpt_boundary_offset = 1

    def __init__(self, cfg: Config, network: Network,
                 rng: Optional[np.random.Generator] = None):
        super().__init__(cfg, network, rng)
        n, k = self.n, self.k
        from svinet_tpu.ops.edges import choose_edge_block
        block = choose_edge_block(len(network.training_links), k)
        edges_p, mask = pad_edges(network.training_links, block)
        self.num_blocks = edges_p.shape[0] // block
        self.edges = jnp.asarray(edges_p)
        self.mask = jnp.asarray(mask)
        self.deg = jnp.asarray(network.training_deg.astype(np.float32))

        if cfg.model_load and cfg.gamma_location:
            g0, l0 = load_model(cfg.gamma_location, n, k, cfg.t)
        elif cfg.use_init_communities and cfg.init_communities_fname:
            network.load_init_communities(cfg.init_communities_fname)
            with open(cfg.file_str("init_memberships.txt"), "w") as f:
                for p, comms in enumerate(network.init_communities_seq):
                    row = "\t".join(str(c) for c in comms)
                    f.write(f"{int(network.seq2id[p])}\t{row}\n")
            deg_all = (network.row_ptr[1:] - network.row_ptr[:-1]).astype(
                np.float64)
            g0 = init_gamma_from_communities(
                network.init_communities_seq, deg_all, n, k, cfg.alpha)
            l0 = np.tile([cfg.eta0, cfg.eta1], (k, 1))
        elif len(network.edges) * k > (1 << 28):
            # huge E*K: draw the per-link init phis on device, blocked
            ie, im = pad_edges(network.edges, block)
            g0 = init_gamma_from_links_device(
                jax.random.PRNGKey(cfg.seed), jnp.asarray(ie),
                jnp.asarray(im), n, k, jnp.float32(cfg.alpha),
                ie.shape[0] // block)
            l0 = np.tile([cfg.eta0, cfg.eta1], (k, 1))
        else:
            g0 = init_gamma_from_links(self.rng, network.edges, n, k,
                                       cfg.alpha)
            l0 = np.tile([cfg.eta0, cfg.eta1], (k, 1))
        self.gamma = jnp.asarray(g0, jnp.float32)
        self.lam = jnp.asarray(l0, jnp.float32)

        self.consts = LSConsts(
            alpha=jnp.float32(cfg.alpha),
            eta=jnp.asarray([cfg.eta0, cfg.eta1], jnp.float32),
            ones=jnp.float32(network.ones),
            n_nodes=jnp.float32(n))

        self.annealing = True
        self._compact = None     # active-K compaction state (-prune)
        self._ce_cache = (self.edges, self.mask)  # reuse for communities
        # -freeze: STICKY per-node converged flags, carried through every
        # sweep (reference: _converged assigned by prune() and never
        # cleared, src/linksampling.cc:472-473); 0 = free, else column+1
        self._conv = (jnp.zeros(n, jnp.int32)
                      if cfg.freeze_converged else None)

        # -sparse-w W: top-W union sweep (single-device; engages after
        # annealing — the reference's pruning only starts late too,
        # src/linksampling.cc:634). Supersedes -fuse-s3 (the lagged s3
        # rides the sparse pass) and excludes the dense-path extras.
        if cfg.sparse_w:
            if cfg.mesh_devices > 1 or cfg.mesh_rowshard:
                raise SystemExit("-sparse-w is single-device; drop -mesh")
            if cfg.freeze_converged:
                raise SystemExit("-sparse-w does not support -freeze")
            if cfg.sparse_w >= self.k:
                print(f"+ -sparse-w {cfg.sparse_w} >= k={self.k}; "
                      "running dense")
                cfg.sparse_w = 0
            else:
                cfg.prune = False
                cfg.fuse_s3 = False
                cfg.plog("sparse union width", cfg.sparse_w)

        if cfg.fuse_s3 and cfg.freeze_converged:
            print("+ -fuse-s3 has no converged-freezing fast path; "
                  "running unfused to honor -freeze")
            cfg.fuse_s3 = False
        if cfg.freeze_converged and (cfg.mesh_devices > 1
                                     or cfg.mesh_rowshard):
            # must match the mesh-path condition below exactly: a
            # `-mesh 1 -mesh-rowshard` run also takes the mesh sweep,
            # which has no conv operand
            raise SystemExit("-freeze is not supported under -mesh / "
                             "-mesh-rowshard; drop one of the flags")
        if cfg.fuse_s3:
            cfg.plog("fuse s3", True)
        if cfg.bf16_rows:
            cfg.plog("bf16 rows", True)

        # -mesh N: data-parallel sweep over a device mesh — training links
        # sharded, gamma/lambda replicated, sufficient statistics psum'd
        # (the sharded equivalent of the reference's pthread map-reduce,
        # src/mmsbinfer.cc:2400-2550)
        self._mesh_sweep = None
        self._mesh_trace = None
        # -mesh 1 -mesh-rowshard is allowed: a 1-device mesh with
        # degenerate collectives, used to exercise the row-sharded
        # large-n path (and its sharded checkpoints) on a single chip
        if cfg.mesh_devices > 1 or (cfg.mesh_devices == 1
                                    and cfg.mesh_rowshard):
            from jax.sharding import NamedSharding, PartitionSpec as P
            from svinet_tpu.parallel.mesh import (
                make_mesh, shard_edges, make_sharded_multi_sweep,
                make_rowsharded_multi_sweep, device_put_sharded_edges,
                device_put_replicated)
            nd = cfg.mesh_devices
            if nd > len(jax.devices()):
                raise SystemExit(f"-mesh {nd} but only "
                                 f"{len(jax.devices())} devices visible")
            mesh = make_mesh(nd)
            rowshard = bool(cfg.mesh_rowshard)
            # row padding (round 5): n need not divide nd — gamma/deg/
            # mphi gain (n_pad - n) virtual rows held at (alpha, 0),
            # which no edge or eval pair ever references (the zero
            # degree keeps the mean-indicator correction off them, so
            # they sit at their alpha fixed point); host-facing
            # consumers slice [:n]
            n_pad = ((n + nd - 1) // nd) * nd if rowshard else n
            self._n_pad = n_pad
            # -mesh-locality: boundary-rows-only collectives (requires
            # the fused row-sharded layout; cli.py sets the implied
            # flags and applies Network.reorder_locality first — any
            # permutation is CORRECT, the reorder only shrinks the
            # boundary)
            locality = bool(cfg.mesh_locality) and rowshard and cfg.fuse_s3
            self._locality = locality
            if locality:
                from svinet_tpu.parallel.locality import (
                    locality_edge_layout)
                es, ms, exp_idx, linfo = locality_edge_layout(
                    network.training_links, n_pad, nd, block)
                per_shard = linfo["per_shard"]
                self._locality_info = linfo
                cfg.plog("locality internal frac",
                         round(linfo["internal_frac"], 4))
                cfg.plog("locality boundary rows", linfo["boundary_rows"])
            else:
                es, ms = shard_edges(network.training_links, nd, block)
                per_shard = es.shape[0] // nd
            self.edges, self.mask = device_put_sharded_edges(mesh, es, ms)
            self._rowshard = rowshard
            self._mesh = mesh
            if rowshard and n_pad != n:
                self.gamma = jnp.concatenate([
                    self.gamma,
                    jnp.full((n_pad - n, k), cfg.alpha, jnp.float32)])
                self.deg = jnp.concatenate([
                    self.deg, jnp.zeros(n_pad - n, jnp.float32)])
                cfg.plog("rowshard padded rows", n_pad - n)
            # rowshard composes with multi-host: the report/community/
            # checkpoint paths consume the global row-sharded array
            # directly (jitted eval over global arrays; text dumps via a
            # tiled process_allgather, io/checkpoint.py:host_read)
            repl = NamedSharding(mesh, P())
            if rowshard:
                # large-n: gamma/deg row-sharded, Elogpi all_gathered
                from svinet_tpu.parallel.mesh import (
                    global_put, make_rowsharded_fused_multi_sweep)
                row = NamedSharding(mesh, P("edges"))
                if locality:
                    # locality steps through the trace program only
                    # (the heldout tail always rides it)
                    self._exp_idx = global_put(exp_idx, row)
                    self.mphi = global_put(
                        np.zeros((n_pad, k), np.float32), row)
                elif cfg.fuse_s3:
                    self._mesh_sweep = make_rowsharded_fused_multi_sweep(
                        mesh, per_shard // block,
                        bf16=bool(cfg.bf16_rows))
                    self.mphi = global_put(
                        np.zeros((n_pad, k), np.float32), row)
                else:
                    self._mesh_sweep = make_rowsharded_multi_sweep(
                        mesh, per_shard // block)
                self.gamma = global_put(self.gamma, row)
                self.deg = global_put(self.deg, row)
                self.lam, = device_put_replicated(mesh, self.lam)
                self._mesh_shardings = {"gamma": row, "lam": repl}
                if cfg.fuse_s3:
                    self._mesh_shardings["mphi"] = row
            else:
                from svinet_tpu.parallel.mesh import (
                    make_sharded_fused_multi_sweep)
                if cfg.fuse_s3:
                    self._mesh_sweep = make_sharded_fused_multi_sweep(
                        mesh, per_shard // block,
                        bf16=bool(cfg.bf16_rows))
                    self.mphi, = device_put_replicated(
                        mesh, np.zeros((n, k), np.float32))
                else:
                    self._mesh_sweep = make_sharded_multi_sweep(
                        mesh, per_shard // block)
                self.gamma, self.lam, self.deg = device_put_replicated(
                    mesh, self.gamma, self.lam, self.deg)
                self._mesh_shardings = {"gamma": repl, "lam": repl}
                if cfg.fuse_s3:
                    self._mesh_shardings["mphi"] = repl
            self.consts = LSConsts(*device_put_replicated(
                mesh, *self.consts))
            # ho-tailed trace program for EVERY mesh layout: one dispatch
            # per report boundary (and -report-batch B of them per
            # dispatch) — see make_mesh_trace_sweep
            from svinet_tpu.parallel.mesh import make_mesh_trace_sweep
            self._mesh_trace = make_mesh_trace_sweep(
                mesh, per_shard // block, fused=bool(cfg.fuse_s3),
                rowshard=rowshard, locality=locality)
            del self._ce_cache      # communities rebuild a local pad
            cfg.plog("mesh devices", nd)
            cfg.plog("mesh rowshard", rowshard)

        # -load-test-sets: fixed uniform/biased heldout pair files from
        # the cwd, each with its own per-report likelihood trace
        # (reference: LinkSampling::load_test_sets,
        # src/linksampling.cc:1075-1145)
        self._test_sets = []
        if cfg.load_test_sets:
            import os
            from svinet_tpu.io.writers import ReportFile, write_edgelist
            present = [name for name in ("uniform", "biased")
                       if os.path.exists(f"{name}-heldout-pairs.txt")]
            if not present:
                raise SystemExit(
                    "+ -load-test-sets: neither uniform-heldout-pairs.txt "
                    "nor biased-heldout-pairs.txt found in the cwd")
            for name in present:
                pairs, ys = network.load_pairs_file(
                    f"{name}-heldout-pairs.txt")
                write_edgelist(cfg.file_str(f"{name}-test-pairs.txt"),
                               pairs, ys, network.seq2id)
                cfg.plog(f"loaded {name} test pairs:", len(pairs))
                # per-report trace named as the reference's
                # uniform-hol.txt / biased-hol.txt
                # (reference: src/linksampling.cc:1056-1074)
                self._test_sets.append(
                    (name, self._eval_pairs(pairs),
                     self._eval_pairs(ys.astype(np.int32)),
                     ReportFile(cfg.file_str(f"{name}-hol.txt"),
                                append=bool(cfg.resume))))

        # fold the validation heldout eval into the sweep program's tail
        # (single-process paths): pad the pair set once to whole blocks so
        # every report interval runs ONE device program. Row-sharded gamma
        # gets the COMPACT heldout-row table (rowshard_heldout_layout):
        # its tail all_gathers only the heldout-touched pi rows and
        # psums the sharded-pair sums instead of gathering (n,K).
        self._ho_dev = None
        self._ho_mesh = None
        self._ho_res = None
        import jax as _jax
        m = len(network.validation_pairs)
        # mesh layouts build GLOBAL arrays (global_put handles the
        # multi-process case — every process holds the same host copy);
        # the plain single-device tail stays single-process
        if m and getattr(self, "_rowshard", False):
            from jax.sharding import NamedSharding, PartitionSpec as P
            from svinet_tpu.parallel.mesh import (
                rowshard_heldout_layout, global_put)
            hidx, pp, yy, ww, nb = rowshard_heldout_layout(
                network.validation_pairs,
                network.validation_y.astype(np.int32),
                getattr(self, "_n_pad", n), cfg.mesh_devices)
            row = NamedSharding(self._mesh, P("edges"))
            self._ho_mesh = tuple(
                global_put(a, row) for a in (hidx, pp, yy, ww)
            ) + (nb,)
        elif m:
            blk = min(1 << 17,
                      max(64, 1 << int(np.ceil(np.log2(m)))))
            nb = (m + blk - 1) // blk
            tot = nb * blk
            pp = np.zeros((tot, 2), np.int32)
            pp[:m] = network.validation_pairs
            yy = np.zeros(tot, np.int32)
            yy[:m] = network.validation_y
            ww = np.zeros(tot, np.float32)
            ww[:m] = 1.0
            if getattr(self, "_mesh", None) is not None:
                from svinet_tpu.parallel.mesh import (
                    device_put_replicated)
                hp, hy, hw, hidx = device_put_replicated(
                    self._mesh, pp, yy, ww, np.zeros(1, np.int32))
                self._ho_mesh = (hidx, hp, hy, hw, nb)
            elif _jax.process_count() == 1:
                self._ho_dev = (jnp.asarray(pp), jnp.asarray(yy),
                                jnp.asarray(ww), nb)

        if cfg.resume and self.try_restore():
            print(f"+ resumed from checkpoint at iteration {self.iteration}")

    def _state_dict(self):
        d = super()._state_dict()
        d["annealing"] = bool(self.annealing)
        d["anneal_hist"] = [float(x) for x in
                            getattr(self, "_anneal_hist", [])]
        d["anneal_decl"] = [float(getattr(self, "_anneal_decl", 0)),
                            float(getattr(self, "_anneal_prev_h", 0.0))]
        if self.cfg.fuse_s3 or self.cfg.sparse_w:
            # the carried s3 state: without it a resumed fused run re-runs
            # one transient sweep with s3=0 and resume != uninterrupted
            m = getattr(self, "mphi", None)
            d["mphi"] = (m if m is not None
                         else jnp.zeros((self.gamma.shape[0], self.k),
                                        jnp.float32))
        if self._conv is not None:
            d["conv"] = self._conv   # -freeze sticky flags survive resume
        return d

    def _restore_state(self, state) -> None:
        import jax
        super()._restore_state(state)
        self.annealing = bool(state.get("annealing", False))
        self._anneal_hist = [float(x) for x in
                             state.get("anneal_hist", [])]
        ad = state.get("anneal_decl")
        if ad is not None:
            self._anneal_decl = int(float(np.asarray(ad)[0]))
            self._anneal_prev_h = float(np.asarray(ad)[1])
        m = state.get("mphi")
        if m is not None:
            self.mphi = (m if isinstance(m, jax.Array) else jnp.asarray(m))
        cv = state.get("conv")
        if cv is not None and self.cfg.freeze_converged:
            self._conv = jnp.asarray(cv, jnp.int32)

    def _ckpt_shardings(self):
        """Under -mesh, restore gamma/lam straight onto the mesh layout
        (row-sharded gamma in -mesh-rowshard mode) — the state never
        stages through a single replicated host buffer."""
        return getattr(self, "_mesh_shardings", None)

    def _eval_arrays(self):
        """Row padding (rowshard with n % d != 0): the eval jits see
        only the real n rows."""
        g, l = super()._eval_arrays()
        if getattr(self, "_n_pad", self.n) != self.n:
            g = g[:self.n]
        return g, l

    def _host_gamma_lam(self):
        g, l = super()._host_gamma_lam()
        return g[:self.n], l

    # ------------------------------------------------------------------
    def step(self, n_sweeps: int = 1) -> None:
        """n_sweeps sweeps over all training links, fused into one device
        program (one host round trip); on the single-device paths the
        validation heldout sums ride the same program's tail."""
        ann = jnp.float32(1.0 if self.annealing else 0.0)
        self._ho_res = None
        if self._compact is not None:
            c = self._compact
            if self.cfg.fuse_s3:
                (self.gamma, self.lam,
                 self.mphi) = linksampling_compact_fused_multi_sweep(
                    self.gamma, self.lam, self.mphi, self.edges,
                    self.mask, self.deg, self.consts, c["rest"],
                    c["colmask"], self.num_blocks, n_sweeps)
            else:
                fz = bool(self.cfg.freeze_converged)
                out = linksampling_compact_multi_sweep(
                    self.gamma, self.lam, self.edges, self.mask,
                    self.deg, self.consts, c["rest"], c["colmask"],
                    self.num_blocks, n_sweeps, fz,
                    self._conv if fz else None)
                if fz:
                    self.gamma, self.lam, self._conv = out
                else:
                    self.gamma, self.lam = out
            return
        # -sparse-w: top-W union sweep once annealing is over (during
        # annealing all columns are near-equal and a top-W cut is
        # arbitrary — fall through to the dense path until then)
        if self.cfg.sparse_w and not self.annealing:
            if not hasattr(self, "mphi"):
                self.mphi = jnp.zeros((self.n, self.k), jnp.float32)
            if self._ho_dev is not None:
                hp, hy, hw, nb = self._ho_dev
                (self.gamma, self.lam, self.mphi,
                 self._ho_res) = linksampling_sparse_multi_sweep(
                    self.gamma, self.lam, self.mphi, self.edges,
                    self.mask, self.deg, self.consts, ann, hp, hy, hw,
                    jnp.float32(self.cfg.epsilon), self.num_blocks,
                    n_sweeps, int(self.cfg.sparse_w), nb)
            else:
                z = jnp.zeros(1, jnp.float32)
                (self.gamma, self.lam,
                 self.mphi) = linksampling_sparse_multi_sweep(
                    self.gamma, self.lam, self.mphi, self.edges,
                    self.mask, self.deg, self.consts, ann, z, z, z,
                    jnp.float32(self.cfg.epsilon), self.num_blocks,
                    n_sweeps, int(self.cfg.sparse_w), 0)
            return
        # -bf16 engages only AFTER annealing: the anneal-exit plateau
        # detector needs the f32-resolution nshol trace (measured: bf16
        # wobble during annealing stalls the exit from iter ~76 to ~394
        # on LFR); the post-anneal phase — the bulk of a long run — gets
        # the half-width gathers
        bf = bool(self.cfg.bf16_rows) and not self.annealing
        if getattr(self, "_mesh", None) is not None:
            if self._ho_mesh is not None:
                # ho-tailed trace program with n_batches=1: EVERY mesh
                # layout (replicated/rowshard x fused/unfused) reports in
                # one dispatch
                hidx, hp, hy, hw, nb = self._ho_mesh
                ho = (hidx, hp, hy, hw,
                      jnp.float32(self.cfg.epsilon), nb)
                m_in = (self.mphi if self.cfg.fuse_s3
                        else jnp.zeros((1, 1), jnp.float32))
                g, l, m, trace = self._mesh_trace(
                    self.gamma, self.lam, m_in, self.edges, self.mask,
                    self.deg, self.consts, ann, ho, n_sweeps, 1, bf,
                    exp_idx=getattr(self, "_exp_idx", None))
                self.gamma, self.lam = g, l
                if self.cfg.fuse_s3:
                    self.mphi = m
                self._ho_res = trace[0]
                return
            if self._mesh_sweep is None:
                raise RuntimeError(
                    "-mesh-locality requires a validation split (the "
                    "trace program carries the heldout tail)")
            if self.cfg.fuse_s3:
                (self.gamma, self.lam, self.mphi) = self._mesh_sweep(
                    self.gamma, self.lam, self.mphi, self.edges,
                    self.mask, self.deg, self.consts, ann, n_sweeps, bf)
            else:
                self.gamma, self.lam = self._mesh_sweep(
                    self.gamma, self.lam, self.edges, self.mask,
                    self.deg, self.consts, ann, n_sweeps, bf)
            return
        if self.cfg.fuse_s3:
            # mphi carries across sweeps (zeros at init/resume: one
            # transient sweep with s3=0, converged semantics identical)
            if not hasattr(self, "mphi"):
                self.mphi = jnp.zeros((self.n, self.k), jnp.float32)
            if self._ho_dev is not None:
                hp, hy, hw, nb = self._ho_dev
                (self.gamma, self.lam, self.mphi,
                 self._ho_res) = linksampling_fused_multi_sweep_ho(
                    self.gamma, self.lam, self.mphi, self.edges,
                    self.mask, self.deg, self.consts, ann, hp, hy, hw,
                    jnp.float32(self.cfg.epsilon), self.num_blocks,
                    n_sweeps, nb, bf)
            else:
                (self.gamma, self.lam,
                 self.mphi) = linksampling_fused_multi_sweep(
                    self.gamma, self.lam, self.mphi, self.edges,
                    self.mask, self.deg, self.consts, ann,
                    self.num_blocks, n_sweeps, bf)
            return
        fz = bool(self.cfg.freeze_converged)
        cv = self._conv if fz else None
        if self._ho_dev is not None:
            hp, hy, hw, nb = self._ho_dev
            out = linksampling_multi_sweep_ho(
                self.gamma, self.lam, self.edges, self.mask, self.deg,
                self.consts, ann, hp, hy, hw,
                jnp.float32(self.cfg.epsilon), self.num_blocks, n_sweeps,
                nb, fz, bf, cv)
            if fz:
                self.gamma, self.lam, self._ho_res, self._conv = out
            else:
                self.gamma, self.lam, self._ho_res = out
        elif n_sweeps == 1 and not fz:
            self.gamma, self.lam = linksampling_sweep(
                self.gamma, self.lam, self.edges, self.mask, self.deg,
                self.consts, ann, self.num_blocks, False, bf)
        else:
            out = linksampling_multi_sweep(
                self.gamma, self.lam, self.edges, self.mask, self.deg,
                self.consts, ann, self.num_blocks, n_sweeps, fz, bf, cv)
            if fz:
                self.gamma, self.lam, self._conv = out
            else:
                self.gamma, self.lam = out

    # ------------------------------------------------------------------
    def _expand_if_compacted(self) -> None:
        """Restore the full (n,K) layout before anything host-facing
        (reports, model dumps, checkpoints) touches the state."""
        c = self._compact
        if c is None:
            return
        self.gamma, self.lam = expand_columns(
            self.gamma, self.lam, c["idx"], self.consts.alpha,
            self.consts.eta, self.k)
        if self.cfg.fuse_s3 and getattr(self, "mphi", None) is not None:
            self.mphi = jnp.zeros((self.n, self.k), jnp.float32).at[
                :, c["idx"]].set(self.mphi, mode="drop")
        if self._conv is not None:
            # sticky flags back to FULL column ids: compacted flag c>0
            # refers to compacted column c-1 = full column idx[c-1]
            cv = self._conv
            full_col = jnp.take(c["idx"], jnp.maximum(cv - 1, 0),
                                mode="clip")
            self._conv = jnp.where(cv > 0, full_col + 1, 0).astype(
                jnp.int32)
        self._compact = None

    def _maybe_compact(self) -> None:
        """Engage active-K column compaction for the next report interval
        (dense-layout form of the reference's active-k pruning,
        src/linksampling.cc:634-664): once annealing is over, columns
        where NO node has gamma - alpha >= 1 are dropped to their fixed
        point (alpha, eta) and the sweep runs at the padded active width.
        Like the reference's per-node lists, a dropped community can
        never re-enter (phi is only computed over active columns)."""
        cfg = self.cfg
        if (not cfg.prune or self.annealing
                or getattr(self, "_mesh", None) is not None
                or getattr(self, "_light_report", False)):
            # light replay rows (-report-batch) must not compact: the
            # state belongs to the batch's final iteration and the
            # trigger probe is a device dispatch per row
            return
        from svinet_tpu.io.checkpoint import host_read
        act = host_read(_active_cols(self.gamma, self.consts.alpha))
        ka = int(act.sum())
        if ka == 0:
            return
        kpad = max(8, 1 << int(np.ceil(np.log2(ka))))
        if kpad > cfg.prune_frac * self.k:
            return
        idx = np.full(kpad, self.k, np.int32)   # pads point out of range
        idx[:ka] = np.nonzero(act)[0].astype(np.int32)
        idx_d = jnp.asarray(idx)
        colmask = jnp.asarray(
            (np.arange(kpad) < ka).astype(np.float32))
        self.gamma, self.lam = compact_columns(
            self.gamma, self.lam, idx_d, colmask, self.consts.alpha,
            self.consts.eta, kpad)
        if cfg.fuse_s3:
            m = getattr(self, "mphi", None)
            if m is None:
                m = jnp.zeros((self.n, self.k), jnp.float32)
            self.mphi = jnp.where(
                colmask[None, :] > 0,
                jnp.take(m, idx_d, axis=1, mode="clip"), 0.0)
        # rest counts the columns NOT represented in gamma_c: the
        # (kpad - ka) pad slots already sit inside gamma_c at alpha, so
        # the scalar covers K - kpad columns, not K - ka (counting the
        # pads twice biases the digamma normalizer; the bias is a per-row
        # constant that cancels in the phi softmax, but the Elogpi values
        # themselves would be wrong for any non-softmax consumer)
        self._compact = {"idx": idx_d, "colmask": colmask,
                         "rest": jnp.float32((self.k - kpad) * cfg.alpha),
                         "kpad": kpad, "ka": ka}
        if self._conv is not None:
            # sticky flags into COMPACTED column ids (a frozen node's
            # column always stays active — it keeps receiving the hard
            # +1 — so every flagged column is in idx; 0 if not, for
            # safety)
            inv = np.zeros(self.k + 1, np.int32)      # full col -> c+1
            inv[idx[:ka]] = np.arange(1, ka + 1, dtype=np.int32)
            cv = self._conv
            inv_d = jnp.asarray(inv)
            self._conv = jnp.where(
                cv > 0,
                jnp.take(inv_d, jnp.maximum(cv - 1, 0), mode="clip"),
                0).astype(jnp.int32)
        self.log("prune: %d/%d active communities, sweeping at width %d",
                 ka, self.k, kpad)

    def _heldout(self, pairs, y):
        """Validation-set evals consume the sums computed on device as
        the sweep program's tail (ONE round trip per report); other pair
        sets (test/training-sample) fall through to the standalone jit."""
        if pairs is self.val_pairs and self._ho_res is not None:
            from svinet_tpu.evals.likelihood import result_from_sums
            return result_from_sums(self._ho_res)
        return super()._heldout(pairs, y)

    def report(self) -> bool:
        """EngineBase reporting + the annealing phase switch: the FIRST
        validation plateau ends annealing instead of the run
        (reference: src/linksampling.cc:1036-1043)."""
        self._expand_if_compacted()
        stop = super().report()
        light = getattr(self, "_light_report", False)
        if not light:
            self._log_convergence()
        if self._test_sets and not light:
            from svinet_tpu.evals.likelihood import heldout_stats
            eg, el = self._eval_arrays()
            for name, pairs, ys, rf in self._test_sets:
                res = heldout_stats(eg, el, pairs, ys,
                                    self.cfg.epsilon)
                rf.write(self.iteration, self.duration(), res,
                         self.cfg.zeros_prob, self.cfg.ones_prob)
                # {uniform,biased}_auc.txt: "y P(link)" rows for the set
                # (reference: LinkSampling::biased_auc/uniform_auc,
                # src/linksampling.cc:~1150)
                from svinet_tpu.evals.likelihood import link_probs
                from svinet_tpu.io.checkpoint import host_read
                probs = host_read(link_probs(eg, el, pairs))
                with open(self.cfg.file_str(f"{name}_auc.txt"), "w") as f:
                    for yy, u in zip(np.asarray(ys), probs):
                        f.write(f"{int(yy)} {u:.3f}\n")
        if self.annealing:
            h = getattr(self, "_anneal_hist", [])
            h.append(self.stopper.prev_h)     # prev_h = this report's nshol
            self._anneal_hist = h[-3:]
        if self.annealing:
            # The reference ends annealing at the FIRST stop signal
            # (src/linksampling.cc:1036-1043) — either the relative
            # plateau (why=100) or 3 consecutive declines (why=1). In
            # float32 the nshol trace wobbles at the 1e-5 level mid-
            # descent, so the raw declines rule fires ~50 iterations
            # before the double-precision reference's does and annealing
            # exits far too early (iter ~27 vs ~80 on ca-AstroPh, costing
            # ~8% heldout likelihood). Two robust exit criteria instead:
            #   (a) a genuine tight plateau (1e-6/iteration over two
            #       consecutive reports), or
            #   (b) a deep (>8% relative) drawdown below the best —
            #       f32 wobble dips are ~0.5% (ca-AstroPh) and the slow
            #       post-peak nshol drift of a structure-improving anneal
            #       stays under ~6% (LFR, where NMI keeps climbing),
            #       while a genuinely regressing anneal (K far above the
            #       true community count, where the per-column scale
            #       splits real blocks) digs past 8% and keeps going.
            # Both thresholds are configurable (-anneal-drawdown /
            # -anneal-plateau-rate); the sensitivity study in the README
            # varies them 2x either way on the three tuning graphs.
            genuine_plateau = (self._last_stop_raw
                               and self.stopper.why == 100
                               and self._anneal_plateau())
            mx = self.stopper.max_h
            drawdown = (mx - self.stopper.prev_h) / abs(mx) if mx else 0.0
            regressing = (self.stopper.since_max >= 2
                          and drawdown > self.cfg.anneal_drawdown)
            # (c) SUSTAINED monotone decline: f32 wobble ALTERNATES, so
            # >= ~24 sweeps of strictly declining reports is a genuine
            # post-peak signal even when the drift is far too shallow
            # for the drawdown exit (the reference ends annealing at its
            # first decline streak, src/linksampling.cc:1036-1043;
            # measured on the n=1M stretch: nshol declines monotonically
            # at 7e-6/iteration relative — 11,000 sweeps from an 8%
            # drawdown — while the fit is already converged)
            prev2 = getattr(self, "_anneal_prev_h", None)
            h_now = self.stopper.prev_h
            if prev2 is not None and h_now < prev2:
                self._anneal_decl = getattr(self, "_anneal_decl", 0) + 1
            else:
                self._anneal_decl = 0
            self._anneal_prev_h = h_now
            need = max(3, -(-self.cfg.anneal_decline_sweeps
                            // max(self.cfg.reportfreq, 1)))
            sustained = self._anneal_decl >= need
            if (genuine_plateau or regressing or sustained
                    or self.iteration >= 1000):   # runaway backstop
                self.annealing = False
                self.stopper.reset_after_annealing()
                why = ("plateau" if genuine_plateau else
                       "sustained-decline" if sustained else "no-improve")
                self.log(f"annealing ended at iteration {self.iteration}"
                         f" ({why})")
            else:
                self.stopper.nh = 0
            stop = False
        self._end_of_report()
        if not stop:
            # checkpoint above snapshots the FULL layout; only now narrow
            # the state for the next report interval's sweeps
            self._maybe_compact()
        return stop

    def _anneal_plateau(self) -> bool:
        """Second-level plateau check for the annealing exit: f32 nshol
        improvements stall near the 1e-5 threshold well before the run
        has genuinely flattened, so require a 1e-6 PER-ITERATION relative
        change sustained over the last two reports before leaving the
        annealing phase (the threshold scales with -rfreq, since a report
        interval spans reportfreq sweeps of progress)."""
        h = getattr(self, "_anneal_hist", [])
        if len(h) < 3:
            return False
        a, b, c = h
        if a == 0 or b == 0:
            return False
        thresh = self.cfg.anneal_plateau_rate * max(1, self.cfg.reportfreq)
        return abs((c - b) / b) < thresh and abs((b - a) / a) < thresh

    def _log_convergence(self) -> None:
        """Per-node convergence stats: a node is converged when exactly one
        community holds gamma - alpha >= 1 (reference:
        LinkSampling::check_and_set_converged, src/linksampling.cc:456-475;
        logged to convergence.txt/cmap.txt). The reference uses this to
        freeze nodes; here it is reporting only unless -freeze is set."""
        if not hasattr(self, "_convf"):
            app = bool(self.cfg.resume)
            self._convf = open(self.cfg.file_str("convergence.txt"),
                               "a" if app else "w")
            self._first_conv = np.zeros(self.n, np.int64)
            hosts = self.cfg.file_str("convergence_hosts.txt")
            import os
            if app and os.path.exists(hosts):
                # resume keeps the per-node first-converged times
                for line in open(hosts):
                    parts = line.split()
                    if len(parts) == 3:
                        self._first_conv[int(parts[0])] = int(parts[2])
        # the count reduction runs on device so only (n,) int32 crosses
        # the host link — at the n=1M/k=500 stretch a host gather of
        # gamma is 2 GB per report. Multi-process: the jit consumes the
        # global (replicated or row-sharded) array and host_read gathers
        # just the (n,) counts.
        from svinet_tpu.io.checkpoint import host_read
        active = host_read(_active_counts(self.gamma,
                                          jnp.float32(self.cfg.alpha)))
        active = active[:self.n]      # drop rowshard padding rows
        is_conv = active == 1
        newly = is_conv & (self._first_conv == 0)
        self._first_conv[newly] = max(self.duration(), 1)
        conv = int(is_conv.sum())
        self._convf.write(f"{self.iteration}\t{self.duration()}\t{conv}\t"
                          f"{conv / max(self.n, 1):.5f}\n")
        self._convf.flush()
        # convergence_hosts.txt: per-node first-converged time
        # (reference: MMSBInfer::hosts_conv, src/mmsbinfer.cc:754-790)
        with open(self.cfg.file_str("convergence_hosts.txt"), "w") as f:
            for i in np.nonzero(self._first_conv)[0]:
                f.write(f"{i}\t{int(self.network.seq2id[i])}\t"
                        f"{int(self._first_conv[i])}\n")

    def write_auc(self) -> None:
        """auc.txt: 'y score' rows over the heldout pairs + native AUC in
        auc-all.txt (the reference pipes auc.txt into an external `roc`
        binary; reference: LinkSampling::auc, src/linksampling.cc:854-879)."""
        from svinet_tpu.evals.likelihood import link_probs
        from svinet_tpu.evals.precision import auc as auc_fn
        pairs = (self.network.precision_pairs
                 if len(self.network.precision_pairs)
                 else self.network.validation_pairs)
        ys = (self.network.precision_y
              if len(self.network.precision_pairs)
              else self.network.validation_y)
        eg, el = self._eval_arrays()
        from svinet_tpu.io.checkpoint import host_read
        scores = host_read(link_probs(eg, el, self._eval_pairs(pairs)))
        with open(self.cfg.file_str("auc.txt"), "w") as f:
            for y, s in zip(ys, scores):
                f.write(f"{int(y)} {s:.3f}\n")
        with open(self.cfg.file_str("auc-all.txt"), "a") as f:
            f.write(f"{auc_fn(scores, np.asarray(ys)):.5f}\n")

    def do_on_stop(self, next_iteration=None) -> None:
        self._expand_if_compacted()
        super().do_on_stop(next_iteration=next_iteration)
        self.write_auc()

    # ------------------------------------------------------------------
    def infer(self, max_seconds: Optional[float] = None) -> None:
        cfg = self.cfg
        if cfg.profile_dir:
            # device trace of the training loop (the equivalent of the
            # reference's #ifdef PERF wall-clock probes, SURVEY §5)
            import jax.profiler
            jax.profiler.start_trace(cfg.profile_dir)
            try:
                self._infer_loop(max_seconds)
            finally:
                jax.profiler.stop_trace()
            return
        self._infer_loop(max_seconds)

    def _trace_intervals(self, j: int, r: int, B: int, timef,
                         last_t: float) -> bool:
        """-report-batch: run B report intervals (r sweeps each) in ONE
        dispatch via linksampling_sweep_ho_trace, then replay the B
        heldout-sum rows through the normal report path in order. The
        rows are the EXACT per-boundary values; stop/annealing decisions
        land up to B-1 intervals late (the extra sweeps only converge
        the state further), and the heavyweight per-report extras
        (community extraction, convergence log, test-set evals,
        training-sample rows) run on the batch's final row only.
        Returns True when the run stopped."""
        cfg = self.cfg
        import time as _time
        ann = jnp.float32(1.0 if self.annealing else 0.0)
        bf = bool(cfg.bf16_rows) and not self.annealing
        b_eff = B
        if cfg.max_iterations:
            b_eff = min(B, (cfg.max_iterations - j) // r + 1)
        if cfg.fuse_s3:
            if not hasattr(self, "mphi"):
                self.mphi = jnp.zeros((self.n, self.k), jnp.float32)
            m_in = self.mphi
        else:
            m_in = jnp.zeros((1, 1), jnp.float32)
        if self._ho_mesh is not None:
            # mesh layouts route through the sharded trace program
            hidx, hp, hy, hw, nb = self._ho_mesh
            ho = (hidx, hp, hy, hw, jnp.float32(cfg.epsilon), nb)
            g, l, m, trace = self._mesh_trace(
                self.gamma, self.lam, m_in, self.edges, self.mask,
                self.deg, self.consts, ann, ho, r, b_eff, bf,
                exp_idx=getattr(self, "_exp_idx", None))
        else:
            hp, hy, hw, nb = self._ho_dev
            g, l, m, trace = linksampling_sweep_ho_trace(
                self.gamma, self.lam, m_in, self.edges, self.mask,
                self.deg, self.consts, ann, hp, hy, hw,
                jnp.float32(cfg.epsilon), self.num_blocks, r, b_eff, nb,
                bf, bool(cfg.fuse_s3))
        self.gamma, self.lam = g, l
        if cfg.fuse_s3:
            self.mphi = m
        rows = np.asarray(trace)          # one host transfer for B rows
        now = _time.time()
        timef.write(f"{j + (b_eff - 1) * r}\t"
                    f"{(now - last_t) / (b_eff * r):.6f}\t"
                    f"{self.duration()}\n")
        timef.flush()
        for idx in range(b_eff):
            jb = j + idx * r
            self.iteration = jb
            self._ho_res = rows[idx]
            self._light_report = idx < b_eff - 1
            stop = self.report()
            self._light_report = False
            if stop:
                self.do_on_stop(next_iteration=jb + 1)
                return True
        self.iteration = j + (b_eff - 1) * r + 1
        return False

    def _infer_loop(self, max_seconds: Optional[float] = None) -> None:
        cfg = self.cfg
        # per-chunk wall-clock trace (reference: time.txt/stats.txt,
        # SURVEY §5 — the duration column contract)
        timef = open(cfg.file_str("time.txt"), "a" if cfg.resume else "w")
        last_t = time.time()
        r = max(cfg.reportfreq, 1)
        if self.iteration == 0:
            # iteration-0 report (reference ctor does one); a RESUMED run
            # skips it — an extra report at a non-boundary iteration
            # would feed the stopper/annealing history an update the
            # uninterrupted run never saw
            self.report()
            self.iteration = 1   # next report boundary is r, not 0 again
        # -report-batch B: B boundaries per dispatch with exact
        # per-boundary heldout rows — single-device AND every -mesh
        # layout (round-4 review item; -freeze carries conv state the
        # trace body doesn't thread, and -prune compaction is skipped
        # under batching — its trigger regime is empty on real fits
        # anyway)
        B = max(1, int(getattr(cfg, "report_batch", 1)))
        use_trace = (B > 1
                     and (self._ho_dev is not None
                          or self._ho_mesh is not None)
                     and not cfg.freeze_converged
                     and not cfg.sparse_w)
        while True:
            if cfg.max_iterations and self.iteration > cfg.max_iterations:
                self.do_on_stop()
                return
            # the time budget gates BOTH paths (the -report-batch branch
            # `continue`s before the loop tail)
            if (max_seconds is not None
                    and time.time() - self._start > max_seconds):
                self.do_on_stop()
                return
            # run every sweep up to the next report boundary in ONE device
            # call (reports fire at iterations 0, r, 2r, ...)
            j = ((self.iteration + r - 1) // r) * r
            if cfg.max_iterations:
                j = min(j, cfg.max_iterations)
            todo = j - self.iteration + 1
            if use_trace and todo == r and self._compact is None:
                done = self._trace_intervals(j, r, B, timef, last_t)
                last_t = time.time()
                if done:
                    return
                continue
            self.step(todo)
            now = time.time()
            timef.write(f"{j}\t{(now - last_t) / todo:.6f}\t"
                        f"{self.duration()}\n")
            timef.flush()
            last_t = now
            self.iteration = j
            if j % r == 0:
                if self.report():
                    # sweep j and its report are complete: the final
                    # checkpoint stores j+1 (next iteration to run)
                    self.do_on_stop(next_iteration=j + 1)
                    return
            self.iteration = j + 1
