"""FastInit engine (-findk) — community-count estimation.

JAX re-design of the reference's FastInit
(reference: src/fastinit.cc:240-287): sparse label propagation where K is
conceptually n but each node keeps only its top-`width` communities
(width = max degree, reference: src/main.cc:321-327). Per sweep, every
training link votes each endpoint's current max community into the other
endpoint's frequency map (src/fastinit.cc:250-274); set_gamma keeps the
top-`width` labels by count + alpha (src/fastinit.cc:200-237). Runs
log10(n) sweeps; the line count of communities.txt is the estimated K
(README.md:56-67).

The reference's per-node hash maps become one sort-based map-reduce per
sweep, fully on device: emit (dst, label) votes for both edge directions,
sort the composite keys so equal votes are adjacent, segment-count runs,
then a second sort groups each node's runs by descending count and a
rank-within-segment mask extracts the top-`width` (label, count) rows.
No hashing, no data-dependent shapes — two device sorts per sweep.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from svinet_tpu.config import Config
from svinet_tpu.graph import Network
from svinet_tpu.evals.likelihood import HeldoutResult
from svinet_tpu.io.writers import write_communities
from svinet_tpu.svi.base import EngineBase


@functools.partial(jax.jit, static_argnames=("n", "width"))
def vote_topk(labels, edges, mask, n: int, width: int
              ) -> Tuple[jax.Array, jax.Array]:
    """One label-propagation sweep.

    labels: (n,) int32 current max community per node.
    edges: (E,2) int32 training links (padded); mask: (E,) f32.
    Returns (ids (n,width) int32 with sentinel n for empty slots,
             counts (n,width) f32 vote counts).
    """
    e = edges
    valid = mask > 0
    # both directions; invalid votes get dst=n, lab=n (routed to a dump row)
    dst = jnp.concatenate([e[:, 0], e[:, 1]])
    src = jnp.concatenate([e[:, 1], e[:, 0]])
    vmask = jnp.concatenate([valid, valid])
    dst = jnp.where(vmask, dst, n)
    lab = jnp.where(vmask, labels[src], n)
    m = dst.shape[0]

    # first sort: (dst, lab) lexicographic so equal votes are adjacent
    # (stable two-key sort — no int64 composite keys, safe for any n)
    order1 = jnp.lexsort((lab, dst))
    dsts, labs = dst[order1], lab[order1]
    new_run = jnp.concatenate(
        [jnp.ones(1, bool),
         (dsts[1:] != dsts[:-1]) | (labs[1:] != labs[:-1])])
    run_id = jnp.cumsum(new_run) - 1                       # (m,)
    counts = jnp.zeros(m, jnp.int32).at[run_id].add(1)     # run lengths
    run_dst = jnp.full(m, n, jnp.int32).at[run_id].min(dsts)
    run_lab = jnp.full(m, n, jnp.int32).at[run_id].min(labs)
    is_run = counts > 0

    # second sort: group runs by dst, descending count within a node; the
    # underlying stable sort keeps ties in ascending-label order, matching
    # the reference's map-iteration tie-break (src/fastinit.cc:211-231)
    order = jnp.lexsort((m - counts, jnp.where(is_run, run_dst, n)))
    sd = run_dst[order]
    sl = run_lab[order]
    sc = counts[order]
    sv = is_run[order] & (sd < n) & (sl < n)

    pos = jnp.arange(m)
    seg_start = jnp.concatenate([jnp.ones(1, bool), sd[1:] != sd[:-1]])
    start_pos = jax.lax.associative_scan(
        jnp.maximum, jnp.where(seg_start, pos, -1))
    rank = pos - start_pos
    keep = sv & (rank < width)

    row = jnp.where(keep, sd, n)          # dropped rows -> dump row n
    col = jnp.where(keep, rank, 0)
    ids = jnp.full((n + 1, width), n, jnp.int32).at[row, col].set(sl)
    cnt = jnp.zeros((n + 1, width), jnp.float32).at[row, col].set(
        sc.astype(jnp.float32))
    return ids[:n], cnt[:n]


@functools.partial(jax.jit, static_argnames=())
def sparse_pi(ids, cnt, alpha):
    """E[pi] over each node's sparse support: counts + alpha normalized
    (empty slots stay 0; reference: FastInit::estimate_all_pi)."""
    del ids
    val = jnp.where(cnt > 0, cnt + alpha, 0.0)
    return val / jnp.maximum(val.sum(1, keepdims=True), 1e-30)


@jax.jit
def _overlap_block(ids, pi, pairs):
    """Overlap stats for one block of pairs: sum of pi products over SHARED
    community ids and the argmax shared id (reference:
    FastInit::edge_likelihood, src/fastinit.cc:416-439)."""
    ip = ids[pairs[:, 0]][:, :, None]      # (B,w,1)
    iq = ids[pairs[:, 1]][:, None, :]      # (B,1,w)
    pp = pi[pairs[:, 0]][:, :, None]
    qq = pi[pairs[:, 1]][:, None, :]
    n = ids.shape[0]
    same = (ip == iq) & (ip < n)           # sentinel id n never matches
    prod = jnp.where(same, pp * qq, 0.0)   # (B,w,w)
    ssum = prod.sum((1, 2))
    flat = prod.reshape(prod.shape[0], -1)
    amax = flat.argmax(1)
    max_val = jnp.take_along_axis(flat, amax[:, None], 1)[:, 0]
    max_id = jnp.take_along_axis(
        jnp.broadcast_to(ip, prod.shape).reshape(prod.shape[0], -1),
        amax[:, None], 1)[:, 0]
    return ssum, max_val, max_id


def overlap_stats(ids, pi, pairs, block: int = 0):
    """Blocked overlap stats: the (B, w, w) intermediate is bounded to
    block*w*w floats regardless of the edge count. The last chunk is
    padded to the block size so only one program compiles. The default
    block scales inversely with width^2 so wide runs (-findk-width) keep
    the intermediate near 32M floats."""
    if block == 0:
        w = int(ids.shape[1])
        block = max(64, min(2048, (1 << 25) // max(w * w, 1)))
    pairs = jnp.asarray(pairs)
    m = pairs.shape[0]
    if m <= block:
        return _overlap_block(ids, pi, pairs)
    padded = ((m + block - 1) // block) * block
    pairs_p = jnp.concatenate(
        [pairs, jnp.zeros((padded - m, 2), pairs.dtype)])
    out_s, out_v, out_i = [], [], []
    for start in range(0, padded, block):
        s, v, i = _overlap_block(ids, pi, pairs_p[start: start + block])
        out_s.append(s)
        out_v.append(v)
        out_i.append(i)
    return (jnp.concatenate(out_s)[:m], jnp.concatenate(out_v)[:m],
            jnp.concatenate(out_i)[:m])


class FastInit(EngineBase):
    """Host driver for -findk."""

    dual_heldout_splits = True   # src/fastinit.cc (init_heldout)
    stop_min_iter = 0            # no guard (src/fastinit.cc:548-560)
    stop_decline_reports = 10    # nh > 10 (src/fastinit.cc:560)

    def __init__(self, cfg: Config, network: Network,
                 rng: Optional[np.random.Generator] = None):
        super().__init__(cfg, network, rng)
        n = self.n
        # the reference keeps max-degree-many sparse slots per node
        # (src/main.cc:321-327); beyond ~64 the tail of the vote
        # distribution never wins, so cap the width to bound the
        # O(width^2) overlap tensors on big skewed graphs. -findk-width
        # overrides (width study on ca-AstroPh: README §findk-width).
        self.width = (cfg.findk_width if cfg.findk_width > 0
                      else min(max(int(network.deg.max()), 2), 64))
        self.labels = jnp.arange(n, dtype=jnp.int32)
        from svinet_tpu.ops.edges import pad_edges
        e, m = pad_edges(network.training_links, cfg.edge_block)
        self.edges = jnp.asarray(e)
        self.mask = jnp.asarray(m)
        self.ids = None
        self.cnt = None
        self._resume_if_requested()

    def _state_dict(self):
        d = self._host_state()
        d["labels"] = self.labels
        if self.ids is not None:
            d.update(ids=self.ids, cnt=self.cnt)
        return d

    def _restore_state(self, state) -> None:
        self.labels = self._as_device(state["labels"])
        if "ids" in state:
            self.ids = self._as_device(state["ids"])
            self.cnt = self._as_device(state["cnt"])
        self._restore_host_state(state)

    def batch_infer(self) -> None:
        cfg = self.cfg
        sweeps = int(math.log10(max(self.n, 10))) + 1
        for _ in range(self.iteration, sweeps):
            self.ids, self.cnt = vote_topk(self.labels, self.edges,
                                           self.mask, self.n, self.width)
            # top-1 becomes the node's label; isolated nodes keep theirs
            top = self.ids[:, 0]
            self.labels = jnp.where(top < self.n, top, self.labels)
            self.iteration += 1
            self.report()
        self.do_on_stop()

    # ------------------------------------------------------------------
    def _pi(self):
        return sparse_pi(self.ids, self.cnt, jnp.float32(self.cfg.alpha))

    def _sparse_res(self, pairs, y) -> "HeldoutResult":
        """Heldout stats over a pair set from the sparse top-width model."""
        pi = self._pi()
        ssum, _, _ = overlap_stats(self.ids, pi, pairs)
        y = np.asarray(y)
        s = np.asarray(ssum)
        ll = np.log(np.maximum(np.where(y == 1, s, 1.0 - s), 1e-30))
        ones = y == 1
        return HeldoutResult(
            avg=float(ll.mean()), count=len(ll),
            avg0=float(ll[~ones].mean()) if (~ones).any() else 0.0,
            count0=int((~ones).sum()),
            avg1=float(ll[ones].mean()) if ones.any() else 0.0,
            count1=int(ones.sum()))

    def report(self) -> bool:
        """Sparse heldout likelihood + communities
        (reference: FastInit::heldout_likelihood, src/fastinit.cc:508-560).
        Dual splits: stop on the heldout set, record the validation set
        at new maxima (max.txt col 6), like the other classic engines."""
        cfg = self.cfg
        res = self._sparse_res(self.stop_pairs, self.stop_y)
        nshol = self._hf.write(self.iteration, self.duration(), res,
                               cfg.zeros_prob, cfg.ones_prob)
        if not self._dual:
            self._vf.write(self.iteration, self.duration(), res,
                           cfg.zeros_prob, cfg.ones_prob)
        stop = self._stop_and_write_max(nshol, self._sparse_res)
        self.log_communities()
        self._end_of_report()   # SIGTERM save-and-continue + periodic ckpt
        return stop and cfg.use_validation_stop

    def log_communities(self) -> None:
        """Each training link joins the community of its argmax shared id
        when the normalized max exceeds link_thresh
        (reference: FastInit::compute_and_log_groups, src/fastinit.cc:291-390).
        Line count of communities.txt = estimated K."""
        cfg = self.cfg
        if self.ids is None:
            return
        pi = self._pi()
        tl = self.network.training_links
        ssum, max_val, max_id = overlap_stats(
            self.ids, pi, jnp.asarray(tl))
        ssum = np.asarray(ssum)
        mv = np.asarray(max_val)
        mi = np.asarray(max_id)
        norm = np.where(ssum > 0, mv / np.maximum(ssum, 1e-30), 0.0)
        sel = norm >= cfg.link_thresh
        comms = {}
        for (p, q), c in zip(tl[sel], mi[sel]):
            comms.setdefault(int(c), set()).update((int(p), int(q)))
        self._communities = {c: sorted(v) for c, v in comms.items()}
        write_communities(cfg.file_str("communities.txt"),
                          self._communities, self.network.seq2id)
        with open(cfg.file_str("communities_size.txt"), "w") as f:
            for c in sorted(self._communities):
                f.write(f"{c}\t{len(self._communities[c])}\n")
        if self._mutual is not None:
            from svinet_tpu.evals.nmi import overlapping_nmi, read_cover_file
            ours = read_cover_file(cfg.file_str("communities.txt"))
            gt = read_cover_file(cfg.file_str("ground_truth.txt"))
            self._mutual.write(
                f"mutual3:\t{overlapping_nmi(gt, ours):g}\n")
            self._mutual.flush()

    def do_on_stop(self, next_iteration=None) -> None:
        self.log_communities()
        # groups.txt: node -> current label (sparse model has no dense gamma)
        with open(self.cfg.file_str("groups.txt"), "w") as f:
            lab = np.asarray(self.labels)
            for i in range(self.n):
                f.write(f"{i}\t{int(self.network.seq2id[i])}\t{int(lab[i])}\n")
        if getattr(self.cfg, "checkpoint_freq", 0.0):
            self.save_checkpoint(next_iteration)
