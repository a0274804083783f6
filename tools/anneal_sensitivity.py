"""Annealing-exit sensitivity study (round-1 VERDICT Weak #2).

The LinkSampling annealing phase exits on (a) a sustained relative-change
plateau below `anneal_plateau_rate` per iteration, or (b) a relative
drawdown below the best nshol deeper than `anneal_drawdown`
(svi/linksampling.py, reference exit: src/linksampling.cc:1036-1043).
Both constants were tuned on three graphs; this harness varies each 2x
up and down around the defaults (0.08 / 1e-6) on those graphs and
tabulates annealing-end iteration, stop iteration, best nshol, and NMI,
so the README can record how (in)sensitive the outcomes are.

Usage:
  python tools/anneal_sensitivity.py               # assort+LFR on CPU
  python tools/anneal_sensitivity.py --astro       # ca-AstroPh rows only
                                                   # (on the GPU, one
                                                   # run at a time)
Each run executes the CLI in a scratch dir and parses mutual.txt /
max.txt / infer.log. Prints a markdown table.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = "/root/reference/example"

GRAPHS = {
    "assort-k20": dict(file=f"{EX}/assort-75-4.txt", n=75, k=20, nmi=""),
    "LFR-k28": dict(file=f"{EX}/LFR-network-n1000-k28.txt", n=1000, k=28,
                    nmi=f"{EX}/LFR-ground-truth-n1000-k28.txt"),
    "astro-k20": dict(file=f"{EX}/ca-AstroPh.csv", n=17903, k=20, nmi=""),
}

# vary one constant at a time around the (0.08, 1e-6) defaults
CONFIGS = [
    (0.08, 1e-6),   # defaults
    (0.04, 1e-6),
    (0.16, 1e-6),
    (0.08, 1e-5),
    (0.08, 1e-7),
]


def run_one(graph: str, drawdown: float, plateau: float, seed: int,
            cpu: bool) -> dict:
    g = GRAPHS[graph]
    label = f"as-{drawdown:g}-{plateau:g}"
    wd = tempfile.mkdtemp(prefix=f"anneal-{graph}-")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    if cpu:
        env["JAX_PLATFORMS"] = "cpu"
    cmd = [sys.executable, "-m", "svinet_tpu", "-file", g["file"],
           "-n", str(g["n"]), "-k", str(g["k"]), "-link-sampling",
           "-seed", str(seed), "-label", label,
           "-anneal-drawdown", str(drawdown),
           "-anneal-plateau-rate", str(plateau),
           "-max-iterations", "400"]
    if g["nmi"]:
        cmd += ["-nmi", g["nmi"]]
    subprocess.run(cmd, cwd=wd, env=env, check=True,
                   capture_output=True, timeout=3600)
    out = next(p for p in os.listdir(wd)
               if os.path.isdir(os.path.join(wd, p)))
    od = os.path.join(wd, out)
    row = {"graph": graph, "drawdown": drawdown, "plateau": plateau,
           "anneal_end": "-", "stop_iter": "-", "best_nshol": "-",
           "nmi": "-"}
    with open(os.path.join(od, "max.txt")) as f:
        toks = f.read().split()
        row["stop_iter"] = toks[0]
        row["best_nshol"] = f"{float(toks[4]):.5f}"
    log = open(os.path.join(od, "infer.log")).read()
    m = re.search(r"annealing ended at iteration (\d+)", log)
    if m:
        row["anneal_end"] = m.group(1)
    mpath = os.path.join(od, "mutual.txt")
    if os.path.exists(mpath):
        vals = [line.split()[-1] for line in open(mpath) if line.strip()]
        if vals:
            row["nmi"] = f"{float(vals[-1]):.3f}"
    return row


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--astro", action="store_true",
                    help="run only the ca-AstroPh rows (serial: one "
                         "JAX process on the GPU at a time)")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    if args.astro:
        graphs, jobs, cpu = ["astro-k20"], 1, False
    else:
        graphs, jobs, cpu = ["assort-k20", "LFR-k28"], args.jobs, True

    work = [(g, d, p) for g in graphs for (d, p) in CONFIGS]
    rows = []
    with cf.ThreadPoolExecutor(max_workers=jobs) as ex:
        futs = {ex.submit(run_one, g, d, p, args.seed, cpu): (g, d, p)
                for (g, d, p) in work}
        for fut in cf.as_completed(futs):
            row = fut.result()
            rows.append(row)
            print(f"done: {futs[fut]}", file=sys.stderr)

    rows.sort(key=lambda r: (r["graph"], r["drawdown"], r["plateau"]))
    print("| graph | drawdown | plateau rate | anneal end | stop iter "
          "| best nshol | NMI |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['graph']} | {r['drawdown']:g} | {r['plateau']:g} "
              f"| {r['anneal_end']} | {r['stop_iter']} "
              f"| {r['best_nshol']} | {r['nmi']} |")


if __name__ == "__main__":
    main()
