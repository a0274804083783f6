"""Shared host-side engine scaffolding.

Every reference engine embeds its own copy of the heldout/validation
machinery, report files, stopping rule, community logging, and model
saving (SURVEY §2 #21). Here that lives once: engines subclass
EngineBase and implement the device-side step.
"""

from __future__ import annotations

import time
from typing import Optional

import jax.numpy as jnp
import numpy as np

from svinet_tpu.config import Config
from svinet_tpu.graph import Network
from svinet_tpu.evals.likelihood import heldout_stats
from svinet_tpu.evals.stopping import ValidationStop
from svinet_tpu.evals.nmi import overlapping_nmi, read_cover_file
from svinet_tpu.io.writers import (
    ReportFile, save_model, write_communities, write_groups, write_max,
    write_edgelist,
)
from svinet_tpu.svi.communities import edge_assignments, extract_communities


class EngineBase:
    """Owns output files, heldout splits, the stopping controller, and the
    community/NMI logging. Subclasses own gamma/lam device state and steps."""

    # The classic-SVI engines (MMSBInfer/FastAMM/FastAMM2/FastInit)
    # sample TWO disjoint splits: heldout drives the stopping rule and
    # heldout.txt, validation is evaluated at new maxima and recorded as
    # max.txt column 6 (reference: src/mmsbinfer.cc:206-328, 2145-2170).
    # LinkSampling's reference uses a single split (linksampling.cc:170-179).
    dual_heldout_splits = False

    # Stopping-controller parameters (see evals/stopping.py for the per-
    # engine reference cites). Default = the classic-SVI controller:
    # guard iter > min(n, 5000), plateau why=0, stop after >2 declines.
    # stop_min_iter None means min(n, 5000).
    stop_min_iter: "int | None" = None
    stop_plateau_why = 0
    stop_decline_reports = 2

    # Checkpoints store the NEXT iteration to run. At a report boundary the
    # minibatch engines (MMSB/FastAMM/FastAMM2/SBM/...) have already
    # incremented: their loops resume stepping FROM self.iteration, so the
    # boundary checkpoint stores iteration + 0. LinkSampling's loop sits at
    # the just-completed sweep j at its boundary (next = j + 1) and
    # overrides this to 1.
    ckpt_boundary_offset = 0

    def __init__(self, cfg: Config, network: Network,
                 rng: Optional[np.random.Generator] = None):
        self.cfg = cfg
        self.network = network
        self.rng = rng or np.random.default_rng(cfg.seed)
        self._start = time.time()
        cfg.make_outdir()

        if cfg.load_heldout and cfg.load_heldout_fname:
            network.validation_pairs, network.validation_y = \
                network.load_pairs_file(cfg.load_heldout_fname)
            network.assign_training_links()
        else:
            network.sample_heldout_sets(
                self.rng, dual=self.dual_heldout_splits)
        if cfg.load_test and cfg.load_test_fname:
            network.test_pairs, network.test_y = \
                network.load_pairs_file(cfg.load_test_fname)
            network.assign_training_links()

        self._dual = bool(len(network.heldout_pairs))
        write_edgelist(cfg.file_str("validation-edges.txt"),
                       network.validation_pairs, network.validation_y,
                       network.seq2id)
        # dual-split engines dump each split to its own file
        # (reference: src/mmsbinfer.cc:218-220); single-split engines
        # write the same set under both names
        write_edgelist(cfg.file_str("heldout-edges.txt"),
                       network.heldout_pairs if self._dual
                       else network.validation_pairs,
                       network.heldout_y if self._dual
                       else network.validation_y,
                       network.seq2id)
        if len(network.test_pairs):
            write_edgelist(cfg.file_str("test-edges.txt"),
                           network.test_pairs, network.test_y, network.seq2id)

        # infer.log (reference: Logger, src/log.cc:9-127) + network.dat
        # symlink of the input (reference: src/env.hh:621-625)
        self._log = open(cfg.file_str("infer.log"),
                 "a" if getattr(cfg, "resume", False) else "w")
        self.log("engine: %s  n: %d  k: %d", type(self).__name__,
                 network.n, cfg.k)
        import os
        link = cfg.file_str("network.dat")
        try:
            if not os.path.exists(link) and os.path.exists(cfg.datfname):
                os.symlink(os.path.abspath(cfg.datfname), link)
        except OSError:
            pass

        # training-sample likelihood trace (reference: TRAINING_SAMPLE,
        # training.txt in the bundled runs)
        self._train_sample = self._make_training_sample()
        self._trf = ReportFile(cfg.file_str("training.txt"),
                       append=bool(getattr(cfg, "resume", False)))

        # training-edges.txt: external-id dump of the training links
        from svinet_tpu.io.native import write_edges_tsv
        ext = network.seq2id[network.training_links.astype(np.int64)]
        if not write_edges_tsv(cfg.file_str("training-edges.txt"), ext):
            with open(cfg.file_str("training-edges.txt"), "w") as f:
                for p, q in ext:
                    f.write(f"{int(p)}\t{int(q)}\n")

        if network.ground_truth is not None:
            # both names: ours + the reference's
            # (reference: src/network.cc:253-438 gt loaders)
            for fname in ("ground_truth_stats.txt",
                          "ground_truth_community_sizes.txt"):
                with open(cfg.file_str(fname), "w") as f:
                    for ci, comm in enumerate(network.ground_truth):
                        f.write(f"{ci}\t{len(comm)}\n")

        if network.gt_groups:
            # -groups-file dump: seq id -> group string
            # (reference: Network::load_gt_groups, src/network.cc:769-773)
            with open(cfg.file_str("gt_groups.txt"), "w") as f:
                for seq in sorted(network.gt_groups):
                    f.write(f"{seq}\t{network.gt_groups[seq]}\n")

        if len(network.precision_pairs):
            write_edgelist(cfg.file_str("precision-edges.txt"),
                           network.precision_pairs, network.precision_y,
                           network.seq2id)

        if getattr(network, "str_ids", None):
            # -strid: string <-> compact-id mapping
            # (reference: src/network.cc:131-141)
            with open(cfg.file_str("str2id.txt"), "w") as f:
                for i, s in enumerate(network.str_ids):
                    f.write(f"{s}\t{i}\n")

        self.n, self.k = network.n, cfg.k
        self.val_pairs = self._eval_pairs(network.validation_pairs)
        self.val_y = self._eval_pairs(network.validation_y.astype(np.int32))
        # the STOPPING split: heldout for dual-split engines, otherwise
        # the validation split object itself (identity matters — engine
        # _heldout overrides key off `pairs is self.val_pairs`)
        if self._dual:
            self.stop_pairs = self._eval_pairs(network.heldout_pairs)
            self.stop_y = self._eval_pairs(
                network.heldout_y.astype(np.int32))
        else:
            self.stop_pairs, self.stop_y = self.val_pairs, self.val_y
        self._max_v = -2147483647.0   # validation avg at the best nshol
        self.test_pairs = (self._eval_pairs(network.test_pairs)
                           if len(network.test_pairs) else None)
        self.test_y = (self._eval_pairs(network.test_y.astype(np.int32))
                       if len(network.test_pairs) else None)

        self.iteration = 0
        self.terminate_requested = False   # set by the SIGTERM handler
        self.stopper = ValidationStop(
            stopthresh=cfg.stopthresh,
            min_iter=(min(self.n, 5000) if self.stop_min_iter is None
                      else self.stop_min_iter),
            plateau_why=self.stop_plateau_why,
            decline_reports=self.stop_decline_reports)
        # on -resume keep the previously written metric history
        app = bool(getattr(cfg, "resume", False))
        self._vf = ReportFile(cfg.file_str("validation.txt"), append=app)
        self._hf = ReportFile(cfg.file_str("heldout.txt"), append=app)
        # every reference engine opens logl.txt unconditionally (e.g.
        # src/linksampling.cc:143) but only MMSBInfer/MMSBOrig ever write
        # it (-logl); touch the empty file so output dirs are
        # inventory-identical (engines with -logl reopen it themselves)
        open(cfg.file_str("logl.txt"), "a" if app else "w").close()
        self._tf = (ReportFile(cfg.file_str("test.txt"), append=app)
                    if self.test_pairs is not None else None)
        self._mutual = None
        if cfg.nmi and network.ground_truth is not None:
            network.write_gt_communities(cfg.file_str("ground_truth.txt"))
            self._mutual = open(cfg.file_str("mutual.txt"),
                                "a" if app else "w")
        self._communities = {}

        cfg.write_param_txt()
        cfg.plog("inference n", self.n)
        cfg.plog("total pairs", network.total_pairs)
        cfg.plog("network ones", network.ones)
        cfg.plog("heldout pairs (1s and 0s)", len(network.validation_pairs))

        # gamma/lam set by subclass before infer()
        self.gamma = None
        self.lam = None
        self._last_ckpt = time.time()
        self._tail_res = None     # step-program eval-tail stash

    # ------------------------------------------------------------------
    def duration(self) -> int:
        """Seconds of training time, CUMULATIVE across resumes: checkpoints
        store the accumulated offset so duration-stamped traces
        (convergence_hosts.txt first-converged times, time.txt, the
        report duration column) stay on one monotonic clock across a
        resume boundary."""
        return int(time.time() - self._start) + getattr(
            self, "_dur_offset", 0)

    def log(self, fmt: str, *args) -> None:
        """Timestamped line into <outdir>/infer.log
        (reference: Logger::xlog, src/log.cc:72-127)."""
        msg = (fmt % args) if args else fmt
        self._log.write(f"[{self.duration()}s] {msg}\n")
        self._log.flush()

    def _make_training_sample(self):
        """Fixed random sample of training links + equal nonlinks for the
        per-report training likelihood trace (training.txt)."""
        net = self.network
        m = min(max(len(net.training_links) // 100, 10),
                5000, len(net.training_links))
        if m == 0:
            return None
        idx = self.rng.choice(len(net.training_links), size=m, replace=False)
        links = net.training_links[idx]
        # dense tiny graphs can have fewer nonlink pairs than requested
        nonlinks = net._sample_nonlinks(self.rng, m)
        pairs = np.concatenate([links, nonlinks.astype(np.int32)], axis=0)
        ys = np.concatenate([np.ones(len(links), np.int32),
                             np.zeros(len(nonlinks), np.int32)])
        # host copy kept for the step-program eval tail
        self._train_sample_np = (pairs, ys)
        return self._eval_pairs(pairs), self._eval_pairs(ys)

    # ------------------------------------------------------------------
    def _eval_arrays(self):
        """gamma/lam for the eval jits (heldout stats, community
        extraction) — the live state, in BOTH the single- and
        multi-process cases: jit consumes global (replicated OR
        row-sharded) arrays directly, inserting the cross-shard gathers
        itself, as long as the other eval inputs are uncommitted host
        arrays (see _eval_pairs). This is what lifts the old
        'rowshard is single-host only' restriction."""
        return self.gamma, self.lam

    @staticmethod
    def _eval_pairs(arr):
        """Pair/label arrays for eval jits: committed single-device
        arrays can't mix with multi-process global arrays in one jit, so
        under multi-process they stay as host numpy (jit replicates
        them); single-process keeps them on device."""
        import jax
        if jax.process_count() == 1:
            return jnp.asarray(arr)
        return np.asarray(arr)

    def _host_gamma_lam(self):
        """Full host copies for the text dumps (gamma.txt etc). A
        COLLECTIVE for row-sharded multi-process state — every process
        must call this together (they do: the engine loop is SPMD)."""
        from svinet_tpu.io.checkpoint import host_read
        return host_read(self.gamma), host_read(self.lam)

    # ------------------------------------------------------------------
    def _host_state(self):
        """Host-side scalars every engine checkpoints. The stopping
        controller's history IS state: without it a resumed run restarts
        the plateau/drawdown tracking from scratch and the annealing exit
        (or the stop itself) fires at a different iteration than the
        uninterrupted run's."""
        s = self.stopper
        return {"iteration": self.iteration,
                "dur_offset": self.duration(),
                # _max_v rides along: max.txt column 7 (validation avg at
                # the best nshol) must survive a resume — max_h restores
                # with the stopper, so no new max may ever fire again and
                # the sentinel would otherwise leak into every max.txt row
                "max_v": self._max_v,
                "stopper": [s.prev_h, s.max_h, s.max_t, float(s.nh),
                            float(s.why), float(s.since_max)]}

    def _restore_host_state(self, state) -> None:
        self.iteration = int(state["iteration"])
        self._dur_offset = int(state.get("dur_offset", 0))
        self._max_v = float(state.get("max_v", self._max_v))
        self._start = time.time()
        st = state.get("stopper")
        if st is not None:
            s = self.stopper
            (s.prev_h, s.max_h, s.max_t) = (float(st[0]), float(st[1]),
                                            float(st[2]))
            s.nh, s.why, s.since_max = (int(st[3]), int(st[4]),
                                        int(st[5]))

    def _stop_and_write_max(self, nshol: float, eval_fn):
        """Shared at-max protocol of every reporting engine: update the
        stopper with the heldout nshol; on a NEW heldout max under dual
        splits, evaluate the independent validation split with eval_fn
        and append its 8-column row to validation.txt (reference:
        validation_likelihood at a new max, src/mmsbinfer.cc:2214-2217);
        then rewrite max.txt (7-column with validation-at-max when dual,
        src/mmsbinfer.cc:2165-2169). Returns the raw stop decision."""
        prev_max = self.stopper.max_h
        stop = self.stopper.update(self.iteration, nshol)
        self._last_stop_raw = stop
        if self._dual and self.stopper.max_h > prev_max:
            vres = eval_fn(self.val_pairs, self.val_y)
            self._max_v = vres.avg
            self._vf.write8(self.iteration, self.duration(), vres)
        write_max(self.cfg.file_str("max.txt"), self.iteration,
                  self.duration(), nshol, self.stopper.max_t,
                  self.stopper.max_h, self.stopper.why,
                  max_v=self._max_v if self._dual else None)
        return stop

    @staticmethod
    def _as_device(v):
        """Restored array -> device array; already-sharded jax.Arrays
        (restored onto their mesh layout by io/checkpoint.py) pass
        through untouched."""
        import jax
        return v if isinstance(v, jax.Array) else jnp.asarray(v)

    def _state_dict(self):
        """State captured by native checkpoints; engines whose model
        state is not (gamma, lam) override."""
        d = self._host_state()
        d.update(gamma=self.gamma, lam=self.lam)
        return d

    def _restore_state(self, state) -> None:
        self.gamma = self._as_device(state["gamma"])
        self.lam = self._as_device(state["lam"])
        self._restore_host_state(state)

    def _resume_if_requested(self) -> None:
        """Engines call this at the end of __init__ (device state built):
        -resume restores the newest native checkpoint in the outdir."""
        if getattr(self.cfg, "resume", False) and self.try_restore():
            print(f"+ resumed from checkpoint at iteration "
                  f"{self.iteration}")

    def _ckpt_shardings(self):
        """{array name: jax Sharding} for restoring state straight into
        its device layout; engines running on a mesh override this."""
        return None

    def _ckpt_dir(self) -> str:
        """Canonical checkpoint location: process 0's outdir in
        multi-host runs (cli.py sets ckpt_outdir before appending the
        per-process proc<i>/ suffix), so every process saves to and
        resumes from the SAME state and iteration."""
        return getattr(self.cfg, "ckpt_outdir", "") or self.cfg.outdir

    def save_checkpoint(self, iteration: "int | None" = None) -> None:
        """iteration overrides the stored step; checkpoints store the
        NEXT iteration to run, so a save taken after sweep j completes
        (report boundaries, SIGTERM) passes j+1 — a resumed run must not
        repeat sweep j or double-feed the stopper."""
        from svinet_tpu.io.checkpoint import save_checkpoint
        state = self._state_dict()
        if iteration is not None:
            state["iteration"] = int(iteration)
        save_checkpoint(self._ckpt_dir(), state, state["iteration"])
        self._last_ckpt = time.time()

    def try_restore(self) -> bool:
        """Resume from the newest native checkpoint in the output dir
        (the reference's -load reads the TSV model instead,
        src/linksampling.cc:1266-1352 — both paths are supported)."""
        import jax
        from svinet_tpu.io.checkpoint import load_checkpoint
        state = load_checkpoint(self._ckpt_dir(),
                                shardings=self._ckpt_shardings())
        restored = state is not None
        if restored:
            self._restore_state(state)
        if jax.process_count() > 1:
            # every process must restore the SAME step or the SPMD loops
            # dispatch collective programs with different trip counts and
            # hang; a mismatch means the canonical (proc-0) checkpoint
            # dir is not visible here — multi-host -resume requires the
            # outdir on a shared filesystem
            from jax.experimental import multihost_utils
            steps = multihost_utils.process_allgather(
                np.asarray([self.iteration if restored else -1],
                           np.int64))
            if len(np.unique(steps)) != 1:
                raise SystemExit(
                    f"+ -resume: processes disagree on the restored "
                    f"iteration ({steps.ravel().tolist()}); multi-host "
                    f"resume requires the output dir on a shared "
                    f"filesystem")
        return restored

    def _maybe_periodic_checkpoint(self) -> None:
        """Called at report boundary `iteration` with that sweep+report
        complete (so the checkpoint stores iteration+1). Under
        multi-process the per-host wall-clock decision (and a SIGTERM
        that may have reached only one host) is OR-agreed across
        processes first — save_checkpoint on row-sharded state is a
        collective, and a subset of processes entering it deadlocks the
        others."""
        import jax
        freq = getattr(self.cfg, "checkpoint_freq", 0.0)
        due = bool(freq and time.time() - self._last_ckpt >= freq)
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            flags = multihost_utils.process_allgather(
                np.asarray([due, self.terminate_requested], np.int32))
            due = bool(flags.reshape(-1, 2)[:, 0].any())
            self.terminate_requested = bool(
                flags.reshape(-1, 2)[:, 1].any())
        if due:
            self.save_checkpoint(self.iteration + self.ckpt_boundary_offset)

    # -- step-program eval tail ---------------------------------------
    # The reference evaluates heldout/validation with separate passes
    # per report (src/mmsbinfer.cc:2085-2174); here each standalone eval
    # would be one more device dispatch. Engines fold
    # the per-report pair-set sums into the TAIL of their fused
    # multi-step device programs (evals/likelihood.py:multi_heldout_sums)
    # and stash the rows here; _heldout then serves the report from the
    # stash — one dispatch per report instead of step + 2-3 evals.

    def _tail_device_sets(self):
        """Cached padded arrays for the tail-evaluated pair sets, in
        order: the stopping split, the validation split (dual engines),
        and the per-report training sample. Returns (pairs_tuple,
        y_tuple, w_tuple, blocks_tuple, names) — None when there is
        nothing to evaluate."""
        if (getattr(self, "_tail_cache_done", False)
                or getattr(self, "_tail_disabled", False)):
            return getattr(self, "_tail_cache", None)
        self._tail_cache_done = True
        net = self.network

        def pad(pairs, y):
            m = len(pairs)
            blk = min(1 << 17, max(64, 1 << int(np.ceil(
                np.log2(max(m, 1))))))
            nb = max((m + blk - 1) // blk, 1)
            tot = nb * blk
            pp = np.zeros((tot, 2), np.int32)
            pp[:m] = pairs
            yy = np.zeros(tot, np.int32)
            yy[:m] = y
            ww = np.zeros(tot, np.float32)
            ww[:m] = 1.0
            return pp, yy, ww, nb

        names, raw = [], []
        stop_np = (net.heldout_pairs if self._dual
                   else net.validation_pairs)
        stop_y = net.heldout_y if self._dual else net.validation_y
        if len(stop_np):
            names.append("stop")
            raw.append(pad(stop_np, stop_y))
        if self._dual and len(net.validation_pairs):
            names.append("val")
            raw.append(pad(net.validation_pairs, net.validation_y))
        tsn = getattr(self, "_train_sample_np", None)
        if tsn is not None:
            names.append("train")
            raw.append(pad(tsn[0], tsn[1]))
        if not names:
            self._tail_cache = None
            return None
        put = self._tail_put
        sets = tuple(zip(*[(put(pp), put(yy), put(ww))
                           for pp, yy, ww, _ in raw]))
        self._tail_cache = (sets[0], sets[1], sets[2],
                            tuple(r[3] for r in raw), names)
        return self._tail_cache

    def _tail_put(self, arr):
        """Device placement for tail arrays; mesh engines override to
        replicate onto their mesh."""
        return jnp.asarray(arr)

    def _stash_tail(self, rows) -> None:
        """rows: (S, 6) sums from the step program's tail, in
        _tail_device_sets order."""
        cache = getattr(self, "_tail_cache", None)
        if cache is None:
            return
        rows = np.asarray(rows)
        self._tail_res = {nm: rows[i] for i, nm in enumerate(cache[4])}

    def _heldout(self, pairs, y) -> "HeldoutResult":
        """Heldout likelihood over a pair set; engines with a non-dense
        gamma representation (sparse top-W, -fastqueue) override this.
        Pair sets whose sums rode the step program's tail are served
        from the stash (identity match on the engine's set objects)."""
        tr = getattr(self, "_tail_res", None)
        if tr:
            from svinet_tpu.evals.likelihood import result_from_sums
            if pairs is self.stop_pairs and "stop" in tr:
                return result_from_sums(tr["stop"])
            if pairs is self.val_pairs:
                key = "val" if "val" in tr else (
                    "stop" if not self._dual else None)
                if key:
                    return result_from_sums(tr[key])
            ts = getattr(self, "_train_sample", None)
            if ts is not None and pairs is ts[0] and "train" in tr:
                return result_from_sums(tr["train"])
        eg, el = self._eval_arrays()
        return heldout_stats(eg, el, pairs, y, self.cfg.epsilon)

    def report(self) -> bool:
        """Stopping-split likelihood + stopping logic. Returns True to
        stop. Dual-split engines stop on the heldout split and record
        the validation split only at new maxima (reference:
        src/mmsbinfer.cc:2085-2170); single-split engines write the same
        rows to both files."""
        cfg = self.cfg
        _mr0 = time.time()
        res = self._heldout(self.stop_pairs, self.stop_y)
        nshol = self._hf.write(self.iteration, self.duration(), res,
                               cfg.zeros_prob, cfg.ones_prob)
        if not self._dual:
            self._vf.write(self.iteration, self.duration(), res,
                           cfg.zeros_prob, cfg.ones_prob)
        light = getattr(self, "_light_report", False)
        if self._tf is not None and not light:
            tres = self._heldout(self.test_pairs, self.test_y)
            self._tf.write(self.iteration, self.duration(), tres,
                           cfg.zeros_prob, cfg.ones_prob)
        if self._train_sample is not None and not light:
            tp, ty = self._train_sample
            trres = self._heldout(tp, ty)
            self._trf.write(self.iteration, self.duration(), trres,
                            cfg.zeros_prob, cfg.ones_prob)
            # stats.txt: the reference's 7-column training-likelihood trace
            # (iter, dur, avg, avg_links, avg_nonlinks, n_links, n_nonlinks;
            # reference: src/mmsbinfer.cc:2366, src/fastamm.cc:1720)
            if not hasattr(self, "_statsf"):
                self._statsf = open(cfg.file_str("stats.txt"),
                                    "a" if cfg.resume else "w")
            self._statsf.write(
                f"{self.iteration}\t{self.duration()}\t{trres.avg:.5f}\t"
                f"{trres.avg1:.5f}\t{trres.avg0:.5f}\t{trres.count1}\t"
                f"{trres.count0}\n")
            self._statsf.flush()
            # -accuracy: done.txt marker on the first training-likelihood
            # plateau, with the NMI appended when available
            # (reference: src/fastamm.cc:1238-1255)
            if cfg.accuracy and not getattr(self, "_done_written", False):
                prev = getattr(self, "_prev_train_avg", 0.0)
                a = trres.avg
                if (prev != 0.0 and a > prev
                        and abs((a - prev) / prev) < 1e-5):
                    self._done_written = True
                    with open(cfg.file_str("done.txt"), "w") as f:
                        f.write(f"{self.iteration}\t{self.duration()}\t"
                                f"{a:.5f}\n")
                        if self._mutual is not None:
                            from svinet_tpu.evals.nmi import (
                                overlapping_nmi, read_cover_file)
                            ours = read_cover_file(
                                cfg.file_str("communities.txt"))
                            gt = read_cover_file(
                                cfg.file_str("ground_truth.txt"))
                            f.write(f"mutual3:\t"
                                    f"{overlapping_nmi(gt, ours):g}\n")
                self._prev_train_avg = a
        self.log("iteration %d: validation nshol %.5f",
                 self.iteration, nshol)

        # time.txt: per-report wall-clock trace; every reference engine
        # opens it (e.g. src/mmsbinfer.cc:114, src/fastamm.cc:211).
        # LinkSampling writes its own per-chunk rows instead.
        if not getattr(self, "writes_own_timefile", False):
            if not hasattr(self, "_timef"):
                self._timef = open(cfg.file_str("time.txt"),
                                   "a" if cfg.resume else "w")
            self._timef.write(f"{self.iteration}\t{self.duration()}\n")
            self._timef.flush()

        stop = self._stop_and_write_max(nshol, self._heldout)
        _mr1 = time.time()
        # Per-report community extraction feeds the NMI trace (mutual.txt,
        # one entry per report in the reference's bundled runs); without
        # -nmi the reference only needs communities at stop, so huge runs
        # skip the ~200s/report extraction (29M-edge argmax + host count
        # at the n=1M stretch). do_on_stop always writes them.
        if ((self._mutual is not None or self.n * self.k <= (1 << 24))
                and not light):
            self.log_communities()
        if not light:
            self._write_mrstats(_mr0, _mr1, time.time())
        if not getattr(self, "defer_report_hooks", False):
            self._end_of_report()
        return stop and cfg.use_validation_stop

    def _write_mrstats(self, t_report0: float, t_evals: float,
                       t_comm: float) -> None:
        """mrstats.txt: per-report phase accounting — the analog of
        the reference's MRStats map/reduce instrumentation
        (reference: src/mmsbinfer.hh:201-241, logged at
        src/mmsbinfer.cc:2631-2669). Columns:

          iteration  duration_s  t_train  t_eval  t_communities

        t_train = wall-clock since the previous report ended (host
        sampling + the fused device step program — the reference's
        init+map+reduce phases, which this design fuses into one
        dispatch); t_eval = the report's likelihood evals + metric-file
        writes; t_communities = link-community extraction + NMI."""
        now = time.time()
        prev = getattr(self, "_mr_prev_end", self._start)
        if not hasattr(self, "_mrf"):
            self._mrf = open(self.cfg.file_str("mrstats.txt"),
                             "a" if getattr(self.cfg, "resume", False)
                             else "w")
        self._mrf.write(
            f"{self.iteration}\t{self.duration()}\t"
            f"{t_report0 - prev:.4f}\t{t_evals - t_report0:.4f}\t"
            f"{t_comm - t_evals:.4f}\n")
        self._mrf.flush()
        self._mr_prev_end = now

    def _end_of_report(self) -> None:
        """Periodic-checkpoint + SIGTERM handling at the END of a report.
        Engines whose report() override updates state AFTER
        super().report() (LinkSampling's annealing decision) set
        defer_report_hooks = True and call this themselves, so the
        checkpoint snapshots the post-decision state — a snapshot taken
        mid-report resumes with a stopper that was updated but an
        annealing history that wasn't.

        Skipped on -report-batch light replay rows: the engine state is
        the BATCH-final one, so a checkpoint keyed to an earlier row's
        iteration would resume by re-running sweeps on an
        already-advanced state; the batch's final row fires both hooks
        with a consistent (iteration, state) pair."""
        if getattr(self, "_light_report", False):
            return
        self._maybe_periodic_checkpoint()
        if self.terminate_requested:
            # SIGTERM: save everything and keep running
            # (reference: src/linksampling.cc:763-766)
            self.terminate_requested = False
            self.log("SIGTERM: saving model state at iteration %d",
                     self.iteration)
            nxt = self.iteration + self.ckpt_boundary_offset
            self.do_on_stop(next_iteration=nxt)
            if not getattr(self.cfg, "checkpoint_freq", 0.0):
                try:
                    self.save_checkpoint(nxt)
                except Exception as e:
                    # the TSV model files above DID save; say plainly
                    # that the native (resumable) checkpoint did not
                    self.log("SIGTERM checkpoint save FAILED (%r) — "
                             "TSV model files written, -resume state "
                             "NOT saved", e)

    def log_communities(self) -> None:
        cfg = self.cfg
        edges, mask = self._community_edges()
        eg, el = self._eval_arrays()
        from svinet_tpu.io.checkpoint import host_read
        argmax, maxval = edge_assignments(eg, el, edges, mask)
        self._communities = extract_communities(
            host_read(argmax), host_read(maxval),
            np.asarray(edges), np.asarray(mask),
            self.n, self.k, cfg.link_thresh, cfg.lt_min_deg)
        write_communities(cfg.file_str("communities.txt"),
                          self._communities, self.network.seq2id)
        # mcount.txt (seq, ext-id, #memberships per node) + aggregate.txt
        # (membership count -> #nodes histogram)
        # (reference: src/fastamm.cc:734-735, 826, 858-882)
        mcount = np.zeros(self.n, np.int64)
        for comm in self._communities.values():
            for node in set(comm):
                mcount[node] += 1
        with open(cfg.file_str("mcount.txt"), "w") as f:
            for i in np.nonzero(mcount)[0]:
                f.write(f"{i}\t{int(self.network.seq2id[i])}\t"
                        f"{int(mcount[i])}\n")
        with open(cfg.file_str("aggregate.txt"), "w") as f:
            vals, counts = np.unique(mcount[mcount > 0],
                                     return_counts=True)
            for v, c in zip(vals, counts):
                f.write(f"{int(v)}\t{int(c)}\n")
        if self._mutual is not None:
            ours = read_cover_file(cfg.file_str("communities.txt"))
            gt = read_cover_file(cfg.file_str("ground_truth.txt"))
            val = overlapping_nmi(gt, ours)
            self._mutual.write(f"mutual3:\t{val:g}\n")
            self._mutual.flush()

    def _community_edges(self):
        """Edge array + mask used for link-community extraction; default is
        the full training-link set (subclasses may override)."""
        if not hasattr(self, "_ce_cache"):
            from svinet_tpu.ops.edges import pad_edges
            e, m = pad_edges(self.network.training_links, self.cfg.edge_block)
            self._ce_cache = (self._eval_pairs(e), self._eval_pairs(m))
        return self._ce_cache

    def do_on_stop(self, next_iteration: "int | None" = None) -> None:
        self.log_communities()
        gamma, lam = self._host_gamma_lam()
        save_model(self.cfg.outdir, gamma, lam, self.network.seq2id)
        write_groups(self.cfg.file_str("groups.txt"),
                     gamma, self.network.seq2id)
        # communities_size.txt + summary.txt (argmax-group census)
        with open(self.cfg.file_str("communities_size.txt"), "w") as f:
            for c in sorted(self._communities):
                f.write(f"{c}\t{len(self._communities[c])}\n")
        counts = np.bincount(gamma.argmax(1), minlength=self.k)
        with open(self.cfg.file_str("summary.txt"), "a") as f:
            f.write("\t".join(str(int(c)) for c in counts) + "\n")
        if getattr(self.cfg, "checkpoint_freq", 0.0):
            # runs with native checkpointing on always end with a final
            # checkpoint, so short runs (< checkpoint_freq) resume too;
            # callers at a completed report boundary pass iteration+1
            # (checkpoints store the next iteration to run)
            self.save_checkpoint(next_iteration)
        self.log("stopped at iteration %d (%d s)", self.iteration,
                 self.duration())
