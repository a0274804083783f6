"""FastAMM2 engine (-stratified -rnode) — stratified node SVI.

JAX re-design of the reference's FastAMM2 (reference:
src/fastamm2.cc:534-702): like FastAMM but with inf_epsilon = 0.5 and
m = 10 non-informative sets of size n/m (src/fastamm2.cc:11-15, 1101);
the preprocessed zero-sets are disabled (NULL, src/fastamm2.cc:1009).
Each iteration flips a fair coin:
(a) informative step — a random start node's training links,
    scale = n / (2 (1 - eps));
(b) non-informative step — n/m random nonlink partners of the start node
    from a shuffled ring, scale = n m / (2 eps).
ALL n nodes update every iteration — nodes outside the minibatch shrink
toward alpha (src/fastamm2.cc:605-624) — which makes the gamma update the
same uniform Robbins-Monro step as classic SVI with gamma_hat = 0 off the
minibatch; the per-node counters all advance together, so the step size
is one scalar. The engine therefore reuses svi_step from svi/mmsb.py.
Reports include precision@10/100/1000 with hitcurve files and the
Adamic-Adar baseline (src/fastamm2.cc:1394-1588).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from svinet_tpu.config import Config
from svinet_tpu.graph import Network
from svinet_tpu.evals.likelihood import link_probs
from svinet_tpu.evals.precision import (
    precision_counts, write_hitcurve, adamic_adar_scores, auc)
from svinet_tpu.svi.base import EngineBase

INF_EPSILON = 0.5   # reference: src/fastamm2.cc:15
M_SETS = 10         # reference: src/fastamm2.cc:11


class FastAMM2(EngineBase):
    """Host driver for -stratified -rnode."""

    dual_heldout_splits = True   # src/fastamm2.cc (init_heldout)

    def __init__(self, cfg: Config, network: Network,
                 rng: Optional[np.random.Generator] = None):
        cfg.create_test_precision_sets = True
        super().__init__(cfg, network, rng)
        n, k = self.n, self.k

        v = 1.0 if k < 100 else 100.0 / k
        g0 = self.rng.gamma(100.0 * v, 0.01, size=(n, k))
        l0 = np.tile([cfg.eta0, cfg.eta1], (k, 1)) + \
            self.rng.gamma(100.0 * (1.0 if k <= 100 else 100.0 / k), 0.01,
                           size=(k, 2))
        self.gamma = jnp.asarray(g0, jnp.float32)
        self.lam = jnp.asarray(l0, jnp.float32)
        self.eta = jnp.asarray(np.tile([cfg.eta0, cfg.eta1], (k, 1)),
                               jnp.float32)
        self.alpha = jnp.float32(cfg.alpha)
        self.log_eps = float(np.log(cfg.epsilon))

        self._shuffled = self.rng.permutation(n)
        self._lambda_start_iter = 0
        self._hitcurve_id = 0
        self._pf = open(cfg.file_str("precision.txt"),
                        "a" if cfg.resume else "w")
        self._block = 512
        max_deg = int(network.training_deg.max()) if n else 1
        setsize = max(1, n // M_SETS)
        pad = max(max_deg, setsize, self._block)
        self._pad = ((pad + self._block - 1) // self._block) * self._block

        # -mesh N: sample pairs sharded, stats psum'd (same sharded step
        # as MMSBInfer — the engine reuses svi_multi_step's math)
        self._mesh = None
        if cfg.mesh_devices > 1:
            import jax
            from svinet_tpu.parallel.mesh import (
                make_mesh, make_sharded_svi_multi_step,
                device_put_replicated)
            nd = cfg.mesh_devices
            if nd > len(jax.devices()):
                raise SystemExit(f"-mesh {nd} but only "
                                 f"{len(jax.devices())} devices visible")
            self._mesh = make_mesh(nd)
            self._nd = nd
            per = max(self._block,
                      ((self._pad + nd - 1) // nd + self._block - 1)
                      // self._block * self._block)
            self._pad = per * nd
            self._mesh_step = make_sharded_svi_multi_step(
                self._mesh, per // self._block, cfg.online_iterations,
                cfg.meanchangethresh)
            (self.gamma, self.lam, self.alpha, self.eta,
             self._log_eps_d, self._tail_eps) = device_put_replicated(
                self._mesh, self.gamma, self.lam, self.alpha, self.eta,
                jnp.float32(self.log_eps), jnp.float32(cfg.epsilon))
            cfg.plog("mesh devices", nd)
        self.precision_pairs = network.precision_pairs
        self.precision_y = network.precision_y

        # FastAMM2 names its split dumps *-pairs.txt rather than
        # *-edges.txt (reference: src/fastamm2.cc:94-117)
        from svinet_tpu.io.writers import write_edgelist
        write_edgelist(cfg.file_str("heldout-pairs.txt"),
                       network.heldout_pairs if self._dual
                       else network.validation_pairs,
                       network.heldout_y if self._dual
                       else network.validation_y,
                       network.seq2id)
        write_edgelist(cfg.file_str("validation-pairs.txt"),
                       network.validation_pairs, network.validation_y,
                       network.seq2id)
        if len(network.precision_pairs):
            write_edgelist(cfg.file_str("precision-pairs.txt"),
                           network.precision_pairs, network.precision_y,
                           network.seq2id)
        self._resume_if_requested()

    def _state_dict(self):
        d = super()._state_dict()
        # without this a resumed run rewrites hitcurve_0.txt onward,
        # clobbering the pre-resume per-report hit curves
        d["hitcurve_id"] = int(self._hitcurve_id)
        return d

    def _restore_state(self, state) -> None:
        super()._restore_state(state)
        self._hitcurve_id = int(state.get("hitcurve_id", 0))
        if self._mesh is not None:
            from svinet_tpu.parallel.mesh import device_put_replicated
            self.gamma, self.lam = device_put_replicated(
                self._mesh, self.gamma, self.lam)

    def _edge_ok(self, lo, hi) -> np.ndarray:
        return self.network.edge_ok_mask(lo, hi)

    # ------------------------------------------------------------------
    def _sample(self) -> Tuple[np.ndarray, np.ndarray, float]:
        n = self.n
        r = int(self.rng.integers(0, n))
        if self.rng.uniform() >= INF_EPSILON:   # informative step
            others = self.network.neighbors(r).astype(np.int64)
            ys = np.ones(len(others), np.int32)
            scale = n / (2.0 * (1.0 - INF_EPSILON))
        else:                                   # non-informative step
            # batched ring walk (svi/sampling.py): same survivors as the
            # reference's scalar scan (src/fastamm2.cc:1101) — heldout
            # exclusion is applied AFTER, below, like the scalar path did
            from svinet_tpu.svi.sampling import (ring_nonlink_scan,
                                                 nonlink_accept)
            setsize = max(1, n // M_SETS)
            start = int(self.rng.integers(0, n))
            others = ring_nonlink_scan(
                self._shuffled, n, start, setsize,
                nonlink_accept(self.network, r, None,
                               require_edge_ok=False))
            ys = np.zeros(len(others), np.int32)
            scale = (float(n) * M_SETS) / (2.0 * INF_EPSILON)
        lo = np.minimum(r, others)
        hi = np.maximum(r, others)
        ok = self._edge_ok(lo, hi) & (others != r)
        pairs = np.stack([lo[ok], hi[ok]], 1).astype(np.int32)
        return pairs, ys[ok], scale

    def _prepare(self, it: int):
        cfg = self.cfg
        pairs, ys, scale = self._sample()
        pad = self._pad
        pp = np.zeros((pad, 2), np.int32)
        yy = np.zeros(pad, np.int32)
        ww = np.zeros(pad, np.float32)
        m = min(len(pairs), pad)
        pp[:m] = pairs[:m]
        yy[:m] = ys[:m]
        ww[:m] = 1.0
        noderhot = (cfg.nodetau0 + it) ** (-cfg.nodekappa)
        rhot = (cfg.tau0 + (it - self._lambda_start_iter + 1)) ** (-cfg.kappa)
        return pp, yy, ww, scale, scale, noderhot, rhot, \
            (0.0 if cfg.nolambda else 1.0)

    def _tail_put(self, arr):
        if self._mesh is not None:
            from svinet_tpu.parallel.mesh import device_put_replicated
            out, = device_put_replicated(self._mesh, arr)
            return out
        return jnp.asarray(arr)

    def _step_many(self, count: int) -> None:
        """Fused report interval (host sampling, device scan) with the
        per-report eval sums riding the program's tail (base.py)."""
        from svinet_tpu.svi.mmsb import svi_multi_step, svi_multi_step_ho
        cfg = self.cfg
        batches = [self._prepare(self.iteration + b) for b in range(count)]
        self._tail_res = None
        tail = self._tail_device_sets()
        if self._mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            from svinet_tpu.parallel.mesh import global_put
            shard = NamedSharding(self._mesh, P(None, "edges"))
            rep = NamedSharding(self._mesh, P())
            st = lambda i, dt, sp: global_put(
                np.stack([b[i] for b in batches]).astype(dt), sp)
            mesh_tail = None
            if tail is not None:
                mesh_tail = (tail[0], tail[1], tail[2], tail[3],
                             self._tail_eps)
            out = self._mesh_step(
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
                num_blocks=self._pad // self._block,
                max_iters=cfg.online_iterations,
                thresh=cfg.meanchangethresh, tail_blocks=tnb)
            self._stash_tail(sums)
            return
        self.gamma, self.lam = svi_multi_step(
            self.gamma, self.lam, stack(0, np.int32), stack(1, np.int32),
            stack(2, np.float32), self.alpha, self.eta,
            stack(3, np.float32), stack(4, np.float32),
            stack(5, np.float32), stack(6, np.float32),
            stack(7, np.float32), jnp.float32(self.log_eps),
            num_blocks=self._pad // self._block,
            max_iters=cfg.online_iterations, thresh=cfg.meanchangethresh)

    def _step(self) -> None:
        self._step_many(1)

    # ------------------------------------------------------------------
    def compute_precision(self) -> Tuple[int, int, int]:
        """Reference: src/fastamm2.cc:1394-1460."""
        if not len(self.precision_pairs):
            return 0, 0, 0
        scores = np.asarray(link_probs(self.gamma, self.lam,
                                       jnp.asarray(self.precision_pairs)))
        c10, c100, c1000, cum = precision_counts(scores, self.precision_y)
        write_hitcurve(
            self.cfg.file_str(f"hitcurve_{self._hitcurve_id}.txt"), cum)
        self._hitcurve_id += 1
        self._pf.write(f"{self.iteration}\t{self.duration()}\t"
                       f"{c10}\t{c100}\t{c1000}\n")
        self._pf.flush()
        return c10, c100, c1000

    def log_adamic_adar_baseline(self) -> None:
        """Reference: src/fastamm2.cc:1503-1588."""
        if not len(self.precision_pairs):
            return
        scores = adamic_adar_scores(self.network, self.precision_pairs)
        c10, c100, c1000, cum = precision_counts(scores, self.precision_y)
        # reference file names/schemas: adamic_adar.txt "c10 c100 c1000"
        # (cumulative) and ad_hitcurve.txt (src/fastamm2.cc:1506, 1581-1588)
        with open(self.cfg.file_str("adamic_adar.txt"), "w") as f:
            f.write(f"{c10}\t{c100}\t{c1000}\n")
        write_hitcurve(self.cfg.file_str("ad_hitcurve.txt"), cum)
        # extra: rank-sum AUC of the baseline (not in the reference)
        with open(self.cfg.file_str("adamic-adar-auc.txt"), "w") as f:
            f.write(f"{auc(scores, self.precision_y):.5f}\n")

    def report(self) -> bool:
        stop = super().report()
        self.compute_precision()
        return stop

    def infer(self) -> None:
        cfg = self.cfg
        self.log_adamic_adar_baseline()
        if cfg.adamic_adar:
            # -adamic-adar: baseline only, no inference (reference exits
            # right after compute_adamic_adar_score, src/fastamm2.cc:131-134)
            return
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
