"""Run configuration.

Equivalent of the reference's ``Env`` struct
(reference: src/env.hh:52-671): every hyperparameter in one dataclass,
the output-directory naming scheme (src/env.hh:503-568), and the
``param.txt`` emission (src/env.hh:571-619).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Config:
    # --- core dimensions -------------------------------------------------
    n: int = 0                      # number of nodes
    k: int = 0                      # number of communities
    t: int = 2                      # Beta variational params per community

    # --- model hyperparameters (reference: src/env.hh:340-408) -----------
    alpha: Optional[float] = None   # Dirichlet prior; default 1/k
    epsilon: float = 1e-30          # cross-community link prob
    eta_type: str = "uniform"       # uniform | fromdata | sparse | dense
    eta0: float = 0.0               # resolved from eta_type at ingest
    eta1: float = 0.0
    # presets (reference: src/env.hh:371-376)
    eta0_dense: float = 4700.59
    eta1_dense: float = 0.77
    eta0_uniform: float = 1.00
    eta1_uniform: float = 1.00
    eta0_sparse: float = 0.97
    eta1_sparse: float = 6.33

    # --- SVI learning-rate machinery (reference: src/env.hh:398-415) -----
    tau0: float = 1024.0
    kappa: float = 0.9
    nodetau0: float = 1024.0
    nodekappa: float = 0.5
    online_iterations: int = 50     # max local-step fixed-point rounds
    meanchangethresh: float = 1e-5  # local-step convergence threshold

    # --- heldout / evaluation (reference: src/env.hh:362-369) ------------
    heldout_ratio: float = 0.01
    precision_ratio: float = 0.001
    stopthresh: float = 1e-5
    use_validation_stop: bool = True
    reportfreq: int = 1
    report_batch: int = 1           # -report-batch B: B report boundaries
                                    # per device dispatch (LinkSampling;
                                    # exact per-boundary heldout rows,
                                    # stop/anneal decisions replay up to
                                    # B-1 sweeps late)
    max_iterations: int = 0         # 0 = unlimited
    link_thresh: float = 0.5
    lt_min_deg: int = 0
    create_test_precision_sets: bool = False

    # --- mode flags (reference: src/main.cc:114-242) ----------------------
    link_sampling: bool = False
    batch: bool = False
    stratified: bool = False
    randomnode: bool = False
    randompair: bool = False
    informative_sampling: bool = False   # -infset
    single: bool = False                 # -single (SBM)
    orig: bool = False                   # -orig (full blockmodel)
    itype: int = 0                       # -itype (orig beta init variant,
                                         # reference: src/mmsbinferorig.cc:74-77)
    findk: bool = False
    gen: bool = False
    ppc: bool = False
    gml: bool = False
    lcstats: bool = False
    preprocess: bool = False
    randzeros: bool = False
    delaylearn: bool = True
    nolambda: bool = False
    undirected: bool = True
    logl: bool = False
    accuracy: bool = False
    adamic_adar: bool = False       # score the AA baseline and exit
                                    # (reference: src/fastamm2.cc:131-134)
    nonuniform: bool = False
    strid: bool = False
    disjoint: bool = False
    deterministic: bool = False     # reproducible init + heldout walk
                                    # (reference: src/env.hh:446)

    # --- sampling sizes ---------------------------------------------------
    s: int = 0                      # minibatch size (n/2 default, set at resolve)
    subsample_scale: int = 1
    infthresh: float = 0.0

    # --- I/O ---------------------------------------------------------------
    datfname: str = "network.dat"
    label: str = ""
    seed: int = 0
    nmi: bool = False
    ground_truth_fname: str = ""
    groups_file: str = ""
    model_load: bool = False
    gamma_location: str = ""
    load_heldout: bool = False
    load_heldout_fname: str = ""
    load_test: bool = False
    load_test_fname: str = ""
    load_test_sets: bool = False    # uniform/biased-heldout-pairs.txt
    use_init_communities: bool = False
    init_communities_fname: str = ""
    # -force / -no-force: the reference defaults to overwrite
    # (src/main.cc:49 `force_overwrite_dir = true`); its refusal path
    # (Logger::setup_log_dir, src/log.cc:107-126: "Error: dir ... already
    # exists") is implemented here and reachable via -no-force
    force_overwrite_dir: bool = True
    outdir: str = ""                # resolved by resolve()
    ckpt_outdir: str = ""           # canonical checkpoint dir; multi-host
    # runs point every process here (process 0's outdir) so -resume
    # restores the SAME state and iteration everywhere instead of proc>0
    # finding its own empty proc<i>/ckpt and restarting at 0

    # --- generator / ppc ---------------------------------------------------
    ppc_ndraws: int = 100
    eta0_gen: float = 4700.59
    eta1_gen: float = 0.77

    # --- device execution --------------------------------------------------
    num_devices: int = 0            # 0 = all visible devices
    edge_block: int = 8192          # padding granularity for edge arrays
    mesh_devices: int = 0           # -mesh N: data-parallel link-sampling
                                    # over N devices (0 = single device)
    mesh_rowshard: bool = False     # -mesh-rowshard: shard gamma rows too
                                    # (large-n regime; needs n % N == 0)
    sparse_w: int = 0               # -sparse-w W: top-W union sweep for
                                    # LinkSampling at huge K (the
                                    # reference's active-list pruning
                                    # regime, src/linksampling.cc:634-664)
    mesh_locality: bool = False     # -mesh-locality: BFS node reorder +
                                    # boundary-rows-only collectives for
                                    # the row-sharded sweep (implies
                                    # -mesh-rowshard -fuse-s3)
    freeze_converged: bool = False  # -freeze: reference's converged-node
                                    # hard assignments (consolidates
                                    # communities when K overshoots)
    fuse_s3: bool = False           # -fuse-s3: fold the s3 cross-moment
                                    # gathers into the phi pass over a
                                    # packed (n,2K) array, lagging s3 by
                                    # one sweep
    bf16_rows: bool = False         # -bf16: store the gathered Elogpi /
                                    # packed rows in bfloat16 (half the
                                    # gather bytes); accumulation and
                                    # all state stay f32
    prune: bool = False             # active-K column compaction after
                                    # annealing (dense-layout form of the
                                    # reference's active-k pruning,
                                    # src/linksampling.cc:634-664);
                                    # default OFF: the trigger regime is
                                    # empty on real fits (the GPU speed
                                    # of the compact sweep is not
                                    # measured yet); enable with -prune
    prune_frac: float = 0.5         # compact only when the padded active
                                    # width is <= this fraction of K
                                    # (guarantees >= 2x narrower sweeps)
    # annealing-phase exit thresholds (LinkSampling.report; defaults were
    # tuned on assort/LFR/ca-AstroPh, sensitivity table in README §annealing)
    anneal_drawdown: float = 0.08   # relative nshol drop below best that
                                    # marks a regressing anneal
    anneal_decline_sweeps: int = 24  # sustained monotone decline (in
                                    # sweeps) that ends annealing —
                                    # wobble alternates, genuine
                                    # post-peak drift does not
    anneal_plateau_rate: float = 1e-6  # per-iteration relative-change rate
                                       # that counts as a genuine plateau
    findk_width: int = 0            # -findk sparse slots per node
                                    # (0 = min(max degree, 64); study in
                                    # README §findk-width)
    fastqueue_width: int = 0        # -fastqueue W: sparse top-W gamma for
                                    # -infset at huge K (the FastQueue
                                    # equivalent, src/fastqueue.hh; 0=dense)
    # multi-host bring-up (jax.distributed); env vars are the fallback so
    # a launcher can export them once per host instead of editing flags
    dist_coordinator: str = field(
        default_factory=lambda: os.environ.get(
            "SVINET_DIST_COORDINATOR", ""))
    dist_nprocs: int = field(
        default_factory=lambda: int(os.environ.get(
            "SVINET_DIST_NPROCS", "0")))
    dist_procid: int = field(
        default_factory=lambda: int(os.environ.get(
            "SVINET_DIST_PROCID", "0")))
    dtype: str = "float32"
    checkpoint_freq: float = 0.0    # secs between native checkpoints (0=off)
    resume: bool = False            # resume from <outdir>/ckpt if present
    profile_dir: str = ""           # jax.profiler trace dir ("" = off)

    # runtime-resolved (not user-set)
    total_pairs: int = field(default=0, repr=False)
    ones_prob: float = field(default=0.0, repr=False)
    zeros_prob: float = field(default=0.0, repr=False)

    def resolve(self) -> "Config":
        """Fill in derived defaults (alpha=1/k, minibatch size, outdir name)."""
        if self.alpha is None and self.k > 0:
            self.alpha = 1.0 / self.k
        if self.s == 0 and self.n > 0:
            self.s = self.n // 2
        if not self.outdir:
            self.outdir = self._default_outdir()
        if self.batch or self.link_sampling:
            # reference forces rfreq=1 in these modes (src/main.cc:146-153)
            pass
        return self

    def _default_outdir(self) -> str:
        """Output-dir naming scheme (reference: src/env.hh:503-568)."""
        if self.gml or self.lcstats:
            # gml/lcstats load gamma.txt from the cwd and write alongside
            # (reference: src/env.hh:568 uses prefix "gml")
            return "gml"
        parts = []
        if self.gen:
            parts.append("gend-" if self.disjoint else "gen-")
            parts.append(f"n{self.n}-k{self.k}-")
            if self.eta0_gen == self.eta0_sparse:
                parts.append("sparse")
            elif self.eta0_gen == self.eta0_dense:
                parts.append("dense")
            else:
                parts.append("regular")
            return "".join(parts)
        parts.append(f"n{self.n}-k{self.k}")
        if self.label:
            parts.append(self.label)
        elif len(self.datfname) > 3 and "mmsb_gen.dat" not in self.datfname:
            q = os.path.basename(self.datfname)[:2]
            parts.append("xx" if q == ".." else q)
        if self.seed:
            parts.append(f"seed{self.seed}")
        if self.batch:
            parts.append("batch")
        elif self.single:
            parts.append("sbm")
        elif self.informative_sampling:
            parts.append("infset")
        elif self.link_sampling:
            parts.append("linksampling")
        elif self.findk:
            parts.append("findk")
        elif self.orig:
            parts.append("orig")
        else:
            tag = ""
            if self.subsample_scale > 1:
                tag += f"scale{self.subsample_scale}-"
            if self.stratified:
                tag += "S"
            if self.delaylearn:
                tag += "U"
            if self.nolambda:
                tag += "P"
            if self.randompair:
                tag += "rpair"
            if self.randomnode:
                tag += "rnode"
            if self.nonuniform:
                tag += "R"
            if tag:
                parts.append(tag)
        if self.itype > 0:
            parts.append(f"i{self.itype}")   # reference: src/env.hh:551-552
        return "-".join(parts)

    # ------------------------------------------------------------------
    def set_eta(self, total_pairs: int, ones: int) -> None:
        """Resolve eta from eta_type (reference: src/network.cc:222-251)."""
        self.total_pairs = total_pairs
        self.ones_prob = float(ones) / total_pairs if total_pairs else 0.0
        self.zeros_prob = 1.0 - self.ones_prob
        if self.eta_type == "fromdata":
            self.eta0 = total_pairs * self.ones_prob / self.k
            self.eta1 = total_pairs * 1.0 / (self.k * self.k) - self.eta0
            if self.eta1 <= 0:
                self.eta1 = 1.0
        elif self.eta_type == "uniform":
            self.eta0 = self.eta0_uniform
            self.eta1 = self.eta1_uniform
        elif self.eta_type == "sparse":
            self.eta0 = self.eta0_sparse
            self.eta1 = self.eta1_sparse
        elif self.eta_type == "dense":
            self.eta0 = self.eta0_dense
            self.eta1 = self.eta1_dense
        else:
            raise ValueError(f"unknown eta_type {self.eta_type!r}")

    # ------------------------------------------------------------------
    def file_str(self, name: str) -> str:
        """Path of an output file inside the run's output directory."""
        return os.path.join(self.outdir, name.lstrip("/"))

    def make_outdir(self) -> None:
        """Create the output dir; with -no-force an existing NON-EMPTY
        dir is refused (reference: Logger::setup_log_dir,
        src/log.cc:107-126), except when resuming into it (-resume)."""
        if (not self.force_overwrite_dir and not self.resume
                and not getattr(self, "_outdir_checked", False)
                and os.path.isdir(self.outdir) and os.listdir(self.outdir)):
            raise SystemExit(
                f"Error: dir {self.outdir} already exists "
                f"(use -force to overwrite)")
        object.__setattr__(self, "_outdir_checked", True)
        os.makedirs(self.outdir, exist_ok=True)

    def write_param_txt(self) -> None:
        """Emit param.txt with every effective parameter
        (reference: src/env.hh:571-619)."""
        self.make_outdir()
        rows = [
            ("nodes", self.n),
            ("groups", self.k),
            ("t", self.t),
            ("minibatch (rpair or stratified rpair options only)", self.s),
            ("alpha", _f(self.alpha or 0.0)),
            ("heldout_ratio", _f(self.heldout_ratio)),
            ("precision_ratio", _f(self.precision_ratio)),
            ("stratified", self.stratified),
            ("delaylearn", self.delaylearn),
            ("nolambda", self.nolambda),
            ("randomnode", self.randomnode),
            ("gen", self.gen),
            ("undirected", self.undirected),
            ("stopthresh", _f(self.stopthresh)),
            ("infthresh", _f(self.infthresh)),
            ("randzeros", self.randzeros),
            ("max iterations", self.max_iterations),
            ("seed", _f(self.seed)),
            ("use validation stop", self.use_validation_stop),
            ("gamma location", self.gamma_location),
            ("link_thresh", _f(self.link_thresh)),
            ("lt_min_deg", self.lt_min_deg),
            ("epsilon", _f(self.epsilon)),
            ("reportfreq", self.reportfreq),
            ("eta_type", self.eta_type),
            ("eta0", _f(self.eta0)),
            ("eta1", _f(self.eta1)),
            ("tau0", _f(self.tau0)),
            ("kappa", _f(self.kappa)),
            ("nodetau0", _f(self.nodetau0)),
            ("nodekappa", _f(self.nodekappa)),
        ]
        with open(self.file_str("param.txt"), "w") as f:
            for key, val in rows:
                f.write(f"{key}: {val}\n")

    def plog(self, key: str, val) -> None:
        """Append a key:value line to param.txt (reference: Env::plog)."""
        self.make_outdir()
        with open(self.file_str("param.txt"), "a") as f:
            f.write(f"{key}: {val}\n")


def _f(x: float) -> str:
    return f"{x:.9f}"
