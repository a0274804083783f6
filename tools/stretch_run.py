"""End-to-end n=1M / k=500 stretch run (BASELINE.json stretch target).

This harness runs REAL inference at the stretch scale, end to end:

  1. --gen    generate a planted a-MMSB graph with the sparse
              Poisson-thinned generator (svi/gen.py): n=1M, k=500,
              -disjoint memberships, beta ~ Beta(3, 97) (mean 0.03 ->
              ~30M links, within-community density 0.03), plus the
              planted ground-truth cover. The regime was calibrated at
              n=70k: overlapping Dir(0.05) memberships at density 0.01
              are UNLEARNABLE by this model class — the REBUILT REFERENCE
              collapses identically (heldout link logL -12.0 vs ours
              -11.8) — while disjoint density-0.03 recovers the planted
              cover at NMI 0.92 with a clean annealing plateau exit.
  2. --run    LinkSampling inference through the CLI's main(), in this
              process, with -mesh 1 -mesh-rowshard (the large-n
              row-sharded path on one device: sharded gamma, sharded
              checkpoints), heldout eval + nshol stopping + per-chunk
              time.txt.
  3. --score  restore-check the sharded checkpoint, compute the final
              cover NMI vs the planted ground truth, and print a JSON
              summary (Me/s from time.txt, best nshol, iterations).

Run on the GPU (a CPU run at this size is ~100x slower). All stages:
python tools/stretch_run.py --gen --run --score
Every stage runs in this one process, so only one JAX process ever holds
the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N = int(os.environ.get("SVINET_STRETCH_N", 1_000_000))
K = int(os.environ.get("SVINET_STRETCH_K", 500))
SEED = 1
WORKDIR = os.environ.get("SVINET_STRETCH_DIR", "/tmp/svinet-stretch")


def gen() -> None:
    from svinet_tpu.config import Config
    from svinet_tpu.svi.gen import MMSBGen
    os.makedirs(WORKDIR, exist_ok=True)
    os.chdir(WORKDIR)
    cfg = Config(n=N, k=K, gen=True, seed=SEED, disjoint=True,
                 eta0_gen=3.0, eta1_gen=97.0,
                 outdir=os.path.join(WORKDIR, "gen"))
    cfg.resolve()
    t0 = time.time()
    MMSBGen(cfg).gen()
    print(f"+ generation took {time.time() - t0:.0f}s")
    # planted ground-truth cover: argmax community per node, one
    # community per line (the mutual3 cover format). groups.txt rows are
    # "seq ext vals... argmax"; take first and last fields only
    # (np.loadtxt would parse all K+3 columns of the 1M rows).
    comms = {}
    with open(os.path.join(WORKDIR, "gen", "groups.txt")) as f:
        for line in f:
            node = int(line.split("\t", 1)[0])
            c = int(line.rsplit("\t", 1)[1])
            comms.setdefault(c, []).append(node)
    with open(os.path.join(WORKDIR, "gt-cover.txt"), "w") as f:
        for c in sorted(comms):
            f.write(" ".join(str(v) for v in comms[c]) + " \n")
    print(f"+ planted cover: {len(comms)} communities")


LABEL = os.environ.get("SVINET_STRETCH_LABEL", "stretch")


def run(max_iters: int, rfreq: int, fuse_s3: bool = False,
        report_batch: int = 1) -> None:
    from svinet_tpu.cli import main
    os.chdir(WORKDIR)
    argv = ["-file", os.path.join(WORKDIR, "gen", "network_gen.dat"),
            "-n", str(N), "-k", str(K), "-link-sampling",
            "-mesh", "1", "-mesh-rowshard",
            "-seed", str(SEED), "-label", LABEL,
            "-rfreq", str(rfreq), "-max-iterations", str(max_iters),
            "-checkpoint-freq", "300", "-resume"]
    if fuse_s3:
        argv.append("-fuse-s3")
    if report_batch > 1:
        argv += ["-report-batch", str(report_batch)]
    t0 = time.time()
    rc = main(argv)
    if rc != 0:
        raise SystemExit(f"inference run failed (rc={rc})")
    print(f"+ inference took {time.time() - t0:.0f}s")


def _outdir() -> str:
    return os.path.join(WORKDIR, f"n{N}-k{K}-{LABEL}-seed{SEED}"
                                 "-linksampling")


def score() -> None:
    od = _outdir()
    # sharded-checkpoint restore check (row-sharded gamma on a 1-dev mesh)
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from svinet_tpu.io.checkpoint import load_checkpoint
    from svinet_tpu.parallel.mesh import make_mesh
    ck = "absent"
    if os.path.isdir(os.path.join(od, "ckpt")):
        mesh = make_mesh(1)
        state = load_checkpoint(od, shardings={
            "gamma": NamedSharding(mesh, P("edges")),
            "lam": NamedSharding(mesh, P())})
        assert state is not None and state["gamma"].shape[1] == K
        ck = (f"restored iter {int(state['iteration'])}, gamma "
              f"{tuple(state['gamma'].shape)} on "
              f"{state['gamma'].sharding}")
        del state

    # Me/s from the per-chunk time.txt rows (col 2 = secs per sweep)
    rows = np.loadtxt(os.path.join(od, "time.txt"), ndmin=2)
    n_train = sum(1 for _ in open(os.path.join(od, "training-edges.txt")))
    secs_per_sweep = float(np.median(rows[1:, 1])) if len(rows) > 1 else \
        float(rows[0, 1])
    meps = n_train / secs_per_sweep / 1e6

    with open(os.path.join(od, "max.txt")) as f:
        toks = f.read().split()
    best_nshol, stop_iter = float(toks[4]), int(toks[0])

    from svinet_tpu.evals.nmi import overlapping_nmi, read_cover_file
    t0 = time.time()
    ours = read_cover_file(os.path.join(od, "communities.txt"))
    gt = read_cover_file(os.path.join(WORKDIR, "gt-cover.txt"))
    nmi = overlapping_nmi(gt, ours)
    print(f"+ NMI took {time.time() - t0:.0f}s")

    print(json.dumps({
        "n": N, "k": K, "training_links": n_train,
        "median_secs_per_sweep": round(secs_per_sweep, 3),
        "sweep_meps": round(meps, 2),
        "stop_iter": stop_iter, "best_nshol": round(best_nshol, 5),
        "nmi_vs_planted": round(nmi, 4),
        "communities_found": len(ours),
        "checkpoint": ck,
    }))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gen", action="store_true")
    ap.add_argument("--run", action="store_true")
    ap.add_argument("--score", action="store_true")
    ap.add_argument("--max-iters", type=int, default=100)
    ap.add_argument("--rfreq", type=int, default=10)
    ap.add_argument("--fuse-s3", action="store_true",
                    help="run with -fuse-s3 (round-3 sweep fusion)")
    ap.add_argument("--report-batch", type=int, default=1,
                    help="-report-batch B (round-5: rides the rowshard "
                         "trace program)")
    args = ap.parse_args()
    if args.gen:
        gen()
    if args.run:
        run(args.max_iters, args.rfreq, args.fuse_s3, args.report_batch)
    if args.score:
        score()


if __name__ == "__main__":
    main()
