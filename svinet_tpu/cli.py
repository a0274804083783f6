"""svinet-compatible command-line driver.

Accepts the reference's flag names (reference: src/main.cc:114-242,
documented in detailed_readme.txt:3-48) and dispatches with the same
precedence (src/main.cc:268-377): gen -> ppc -> lcstats -> gml -> findk ->
orig -> link-sampling -> single (SBM) -> batch -> infset ->
stratified-rnode -> default MMSBInfer.

Usage:  python -m svinet_tpu -file net.txt -n 1000 -k 28 -link-sampling
"""

from __future__ import annotations

import os
import signal
import sys
from typing import List, Optional

from svinet_tpu.config import Config
from svinet_tpu.graph import Network

USAGE = """\
SVINET-TPU: stochastic variational inference of undirected networks in JAX
svinet [OPTIONS]
\t-help\t\tusage
\t-file <name>\tinput tab-separated file with a list of undirected links
\t-n <N>\t\tnumber of nodes in network
\t-k <K>\t\tnumber of communities
\t-batch\t\trun batch variational inference
\t-stratified\tuse stratified sampling (with -rpair or -rnode)
\t-rnode\t\tinference using random node sampling
\t-rpair\t\tinference using random pair sampling
\t-link-sampling\tinference using link sampling
\t-infset\t\tinference using informative set sampling
\t-preprocess\tpreprocess to run informative set sampling
\t-findk\t\testimate the number of communities
\t-single\t\tstochastic blockmodel inference
\t-orig\t\tfull-blockmodel (Airoldi et al.) batch inference
\t-itype <0|1>\torig beta init: 0 random, 1 data-derived assortative
\t-gen\t\tgenerate a network from the model
\t-ppc\t\tposterior predictive checks
\t-gml\t\tgenerate a GML visualization of link communities
\t-nmi <file>\tground-truth communities file; logs NMI per report
\t-rfreq <R>\treport/convergence frequency in iterations
\t-report-batch <B>\tfuse B report boundaries per device dispatch
\t\t(link-sampling; exact per-boundary heldout rows, stop/anneal
\t\tdecisions land up to B-1 sweeps late)
\t-max-iterations <M>\tmaximum iterations (use with -no-stop)
\t-no-stop\tdisable stopping criteria
\t-seed <S>\trandom seed
\t-eta-type <t>\tuniform | fromdata | sparse | dense
\t-heldout-ratio <r>\tfraction of links held out
\t-label <s>\ttag output directory
\t-mesh <N>\tshard the link-sampling sweep across N devices
\t-mesh-rowshard\talso shard gamma rows (for n*K beyond one device's memory)
\t-mesh-locality\tnode-locality partition: boundary-rows-only collectives
\t\t(implies -mesh-rowshard -fuse-s3)
\t-sparse-w <W>\ttop-W union sweep for link-sampling at huge K
\t-dist-coordinator <host:port>\tmulti-host coordinator address
\t-dist-nprocs <N>\tnumber of hosts (launch one process per host)
\t-dist-procid <I>\tthis host's process index
\t-freeze\t\tfreeze converged nodes (consolidates overshot K)
\t-fuse-s3\tfold the s3 cross-moment into the phi pass (1-sweep lag)
\t-bf16\tstore gathered sweep rows in bfloat16 (f32 accumulation)
\t-prune\tenable active-K column compaction after annealing (default off)
\t-no-force\trefuse to overwrite an existing non-empty output dir
\t-prune-frac F\tcompact when padded active width <= F*K (default 0.5)
\t-fastqueue <W>\tsparse top-W gamma for -infset at huge K
\t-findk-width <W>\toverride -findk's sparse label slots per node
\t-anneal-drawdown <d>\tannealing-exit drawdown threshold (default 0.08)
\t-anneal-plateau-rate <r>\tannealing-exit plateau rate (default 1e-6)
\t-anneal-decline-sweeps <s>\tsustained-decline annealing exit (default 24)
"""


def parse_args(argv: List[str]) -> Config:
    cfg = Config()
    rfreq_set = False
    i = 0
    while i < len(argv):
        a = argv[i]

        def nxt() -> str:
            nonlocal i
            i += 1
            if i >= len(argv):
                print("+ insufficient arguments!", file=sys.stderr)
                sys.exit(-1)
            return argv[i]

        if a == "-help":
            print(USAGE)
            sys.exit(0)
        elif a == "-file":
            cfg.datfname = nxt()
        elif a == "-n":
            cfg.n = int(nxt())
        elif a == "-k":
            cfg.k = int(nxt())
        elif a == "-link-sampling":
            cfg.link_sampling = True
        elif a == "-batch":
            cfg.batch = True
            cfg.reportfreq = 1
            rfreq_set = True
        elif a == "-stratified":
            cfg.stratified = True
        elif a == "-rnode":
            cfg.randomnode = True
        elif a == "-rpair":
            cfg.randompair = True
        elif a == "-findk":
            cfg.findk = True
        elif a == "-single":
            cfg.single = True
            # the reference couples -single with random zero sets: its
            # neighborhood preprocessing for SBM uses RANDOM zeros, not
            # the 2-hop informative walk (src/main.cc:191-193)
            cfg.randzeros = True
        elif a == "-orig":
            cfg.orig = True
        elif a == "-itype":
            cfg.itype = int(nxt())
        elif a == "-mesh":
            cfg.mesh_devices = int(nxt())
        elif a == "-mesh-rowshard":
            cfg.mesh_rowshard = True
        elif a == "-mesh-locality":
            cfg.mesh_locality = True
        elif a == "-sparse-w":
            cfg.sparse_w = int(nxt())
        elif a == "-dist-coordinator":
            cfg.dist_coordinator = nxt()
        elif a == "-dist-nprocs":
            cfg.dist_nprocs = int(nxt())
        elif a == "-dist-procid":
            cfg.dist_procid = int(nxt())
        elif a == "-freeze":
            cfg.freeze_converged = True
        elif a == "-fuse-s3":
            cfg.fuse_s3 = True
        elif a == "-bf16":
            cfg.bf16_rows = True
        elif a == "-prune":
            cfg.prune = True
        elif a == "-no-prune":
            cfg.prune = False
        elif a == "-prune-frac":
            cfg.prune_frac = float(nxt())
        elif a == "-anneal-drawdown":
            cfg.anneal_drawdown = float(nxt())
        elif a == "-anneal-plateau-rate":
            cfg.anneal_plateau_rate = float(nxt())
        elif a == "-anneal-decline-sweeps":
            cfg.anneal_decline_sweeps = int(nxt())
        elif a == "-findk-width":
            cfg.findk_width = int(nxt())
        elif a == "-fastqueue":
            cfg.fastqueue_width = int(nxt())
        elif a == "-infset":
            cfg.informative_sampling = True
        elif a == "-preprocess":
            cfg.preprocess = True
            cfg.informative_sampling = True
        elif a == "-randzeros":
            cfg.randzeros = True
        elif a == "-gen":
            cfg.gen = True
        elif a == "-ppc":
            cfg.ppc = True
        elif a == "-lcstats":
            cfg.lcstats = True
        elif a == "-gml":
            cfg.gml = True
        elif a == "-nodelay":
            cfg.delaylearn = False
        elif a == "-nmi":
            cfg.ground_truth_fname = nxt()
            cfg.nmi = True
        elif a == "-rfreq":
            cfg.reportfreq = int(nxt())
            rfreq_set = True
        elif a == "-report-batch":
            cfg.report_batch = int(nxt())
        elif a == "-max-iterations":
            cfg.max_iterations = int(nxt())
        elif a == "-no-stop":
            cfg.use_validation_stop = False
        elif a == "-seed":
            cfg.seed = int(float(nxt()))
        elif a == "-eta-type":
            cfg.eta_type = nxt()
        elif a == "-heldout-ratio":
            cfg.heldout_ratio = float(nxt())
        elif a == "-alpha":
            cfg.alpha = float(nxt())
        elif a == "-checkpoint-freq":
            cfg.checkpoint_freq = float(nxt())
        elif a == "-resume":
            cfg.resume = True
        elif a == "-profile":
            cfg.profile_dir = nxt()
        elif a == "-label":
            cfg.label = nxt()
        elif a == "-load":
            cfg.model_load = True
            cfg.gamma_location = nxt()
        elif a == "-load-validation":
            cfg.load_heldout = True
            cfg.load_heldout_fname = nxt()
        elif a == "-load-test":
            cfg.load_test = True
            cfg.load_test_fname = nxt()
        elif a == "-stopthresh":
            cfg.stopthresh = float(nxt())
        elif a == "-inf":
            cfg.infthresh = float(nxt())
        elif a == "-nonuniform":
            # requires -inf <t>, checked after parsing (reference runs the
            # nonuniform sampler only under `if (_env.infthresh)`,
            # src/mmsbinfer.cc:543-548)
            cfg.nonuniform = True
        elif a == "-strid":
            cfg.strid = True
        elif a == "-groups-file":
            cfg.groups_file = nxt()
        elif a == "-logl":
            cfg.logl = True
        elif a == "-link-thresh":
            cfg.link_thresh = float(nxt())
        elif a == "-lt-min-deg":
            cfg.lt_min_deg = int(nxt())
        elif a == "-scale":
            cfg.subsample_scale = int(nxt())
        elif a == "-accuracy":
            cfg.accuracy = True
        elif a == "-init-communities":
            cfg.use_init_communities = True
            cfg.init_communities_fname = nxt()
        elif a == "-disjoint":
            cfg.disjoint = True
        elif a == "-load-test-sets":
            cfg.load_test_sets = True
        elif a == "-force":
            cfg.force_overwrite_dir = True
        elif a == "-no-force":
            cfg.force_overwrite_dir = False
        elif a == "-adamic-adar":
            # score the Adamic-Adar link-prediction baseline over the
            # precision sample and exit without inference (reference:
            # src/fastamm2.cc:131-134; FastAMM's copy is behind an
            # #ifdef PRECISION_SAMPLE that the shipped build omits)
            cfg.adamic_adar = True
        elif a in ("-online", "-gp", "-bmark"):
            pass  # accepted for compatibility
        elif a == "-nthreads":
            nxt()  # pthreads knob: no meaning here, accepted for compatibility
        else:
            print(f"+ unknown flag {a}", file=sys.stderr)
            sys.exit(-1)
        i += 1

    # reference bumps rfreq to 100 in sampled modes unless given
    if not rfreq_set and (cfg.randomnode or cfg.randompair or cfg.stratified):
        cfg.reportfreq = 100
    if cfg.adamic_adar and not (cfg.stratified and cfg.randomnode):
        # same as the reference: env.adamic_adar is only consulted by
        # FastAMM2 (src/fastamm2.cc:131-134; FastAMM's copy is compiled
        # out), so under any other engine the flag does nothing — warn
        # instead of silently running a full inference
        print("+ -adamic-adar only applies with -stratified -rnode; "
              "ignored for this engine (matching the reference)",
              file=sys.stderr)
    if cfg.nonuniform and cfg.infthresh <= 0:
        print("+ -nonuniform requires -inf <threshold>; it is a no-op "
              "without one (matching the reference dispatch, "
              "src/mmsbinfer.cc:543-548)", file=sys.stderr)
    cfg.resolve()
    return cfg


REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def configure_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache before the first
    compile, and return its directory. JAX_COMPILATION_CACHE_DIR, when
    set, is JAX's own setting and is left alone; otherwise the cache lives
    at the fixed <repo>/.jax_cache (the path is part of the cache key, so
    it must not move between runs)."""
    import jax
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO_DIR, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def load_network(cfg: Config, edges=None) -> Network:
    """The engines' input graph, prepared as main() prepares it: read
    cfg.datfname (or take an (E, 2) id array), drop edgeless nodes, and
    apply the -mesh-locality reorder and the -groups-file metadata."""
    network = Network(cfg)
    if edges is None:
        network.read(cfg.datfname)
    else:
        network.from_arrays(edges[:, 0], edges[:, 1])
    print(f"+ network: n = {network.n}, ones = {network.ones}, "
          f"singles = {network.singles}")
    # engines run on the observed nodes only (reference: src/main.cc:291)
    network.drop_singles()
    if cfg.mesh_locality:
        # -mesh-locality: BFS locality permutation of the seq ids BEFORE
        # any split is sampled (pair keys change base), then the
        # row-sharded fused sweep exchanges only boundary rows
        if not cfg.link_sampling:
            raise SystemExit("-mesh-locality requires -link-sampling")
        cfg.mesh_devices = nd = max(cfg.mesh_devices, 1)
        if not cfg.fuse_s3:
            print("+ -mesh-locality implies -fuse-s3")
            cfg.fuse_s3 = True
        if not cfg.mesh_rowshard:
            print("+ -mesh-locality implies -mesh-rowshard")
            cfg.mesh_rowshard = True
        network.reorder_locality(nd)
    if cfg.groups_file:
        # gt-group metadata; dumped to gt_groups.txt by EngineBase
        # (reference: src/network.cc:154, 721-775)
        network.load_gt_groups(cfg.groups_file)
    return network


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(USAGE)
        return -1
    cfg = parse_args(argv)
    configure_compile_cache()

    if cfg.dist_nprocs > 1:
        # multi-host bring-up BEFORE any jax backend use; every process
        # runs the identical engine loop (SPMD — same file, same seed,
        # same control flow), only process 0 owns the canonical outdir
        from svinet_tpu.parallel.mesh import init_distributed
        init_distributed(cfg.dist_coordinator, cfg.dist_nprocs,
                         cfg.dist_procid)
        import jax
        import os as _os
        print(f"+ distributed: process {jax.process_index()} of "
              f"{jax.process_count()}, {jax.local_device_count()} local / "
              f"{jax.device_count()} global devices")
        # the CANONICAL checkpoint location is process 0's outdir: saves
        # are primary-only, and -resume must restore the same state and
        # iteration on every process (divergent iteration counters on a
        # collective program hang or corrupt the run)
        cfg.ckpt_outdir = cfg.outdir
        if jax.process_index() != 0:
            cfg.outdir = _os.path.join(cfg.outdir,
                                       f"proc{jax.process_index()}")

    if cfg.gen:
        from svinet_tpu.svi.gen import MMSBGen
        MMSBGen(cfg).gen()
        return 0

    network = load_network(cfg)

    # SIGTERM -> save model state and CONTINUE, matching the reference's
    # poll-based design (src/main.cc:29-46 sets env.terminate; engines
    # poll it and run do_on_stop, detailed_readme.txt:108-121). The
    # handler only sets a flag — no device calls in signal context.
    engine_box = {}

    def _term(_sig, _frm):
        eng = engine_box.get("engine")
        if eng is not None:
            eng.terminate_requested = True
        else:
            sys.exit(0)

    signal.signal(signal.SIGTERM, _term)

    if cfg.ppc:
        from svinet_tpu.svi.gen import MMSBGen
        MMSBGen(cfg, network).ppc()
        return 0
    if cfg.lcstats:
        from svinet_tpu.svi.gen import MMSBGen
        MMSBGen(cfg, network).get_lc_stats()
        return 0
    if cfg.gml:
        from svinet_tpu.svi.gen import MMSBGen
        MMSBGen(cfg, network).gml()
        return 0
    if cfg.findk:
        from svinet_tpu.svi.fastinit import FastInit
        engine = FastInit(cfg, network)
        engine_box["engine"] = engine
        engine.batch_infer()
        return 0
    if cfg.orig:
        from svinet_tpu.svi.orig import MMSBOrig
        engine = MMSBOrig(cfg, network)
        engine_box["engine"] = engine
        engine.batch_infer()
        return 0
    if cfg.link_sampling:
        from svinet_tpu.svi.linksampling import LinkSampling
        engine = LinkSampling(cfg, network)
        engine_box["engine"] = engine
        engine.infer()
        return 0
    if cfg.single:
        from svinet_tpu.svi.sbm import SBM
        engine = SBM(cfg, network)
        engine_box["engine"] = engine
        if cfg.informative_sampling:
            engine.infer()
        else:
            engine.batch_infer()
        return 0
    if cfg.batch:
        from svinet_tpu.svi.mmsb import MMSBInfer
        engine = MMSBInfer(cfg, network)
        engine_box["engine"] = engine
        engine.batch_infer()
        return 0
    if cfg.preprocess:
        network.set_neighborhood_sets(cfg)
        return 0
    if cfg.informative_sampling:
        from svinet_tpu.svi.fastamm import FastAMM
        engine = FastAMM(cfg, network)
        engine_box["engine"] = engine
        engine.infer()
        return 0
    if cfg.stratified and cfg.randomnode:
        from svinet_tpu.svi.fastamm2 import FastAMM2
        engine = FastAMM2(cfg, network)
        engine_box["engine"] = engine
        engine.infer()
        return 0
    from svinet_tpu.svi.mmsb import MMSBInfer
    engine = MMSBInfer(cfg, network)
    engine_box["engine"] = engine
    engine.infer()
    return 0


if __name__ == "__main__":
    sys.exit(main())
