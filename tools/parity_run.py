"""Scripted parity harness: rebuild the reference, run both sides, emit
the BASELINE.md table.

One command regenerates the statistical-parity evidence instead of the
round-1 by-hand recipe:

    python tools/parity_run.py               # full: 3 seeds x all configs
    python tools/parity_run.py --quick       # seed 1, assort + LFR only
    python tools/parity_run.py --skip-build  # reuse /tmp/svinet_ref_build

Steps:
  1. copy /root/reference/src to a scratch build dir and compile it with
     the checked-in GSL shim (tools/gslshim — std::mt19937_64 +
     double-precision digamma; statistically equivalent to real GSL, not
     bit-compatible, which parity does not require);
  2. run reference binary and `python -m svinet_tpu` with IDENTICAL flags
     per config/seed (ours forced onto the virtual CPU mesh);
  3. score both sides the same way: NMI via the certified in-process
     Lancichinetti scorer (svinet_tpu/evals/nmi.py, cross-checked against
     an independent C++ implementation in tests/test_nmi_cert.py) on each
     side's own communities.txt/ground_truth.txt, best nshol + stop
     iteration from max.txt, final validation avg from validation.txt;
  4. print the markdown table and write it to PARITY_RUN.md.

Configs mirror BASELINE.md "Reference rebuilt and measured on this
machine": LFR n=1000/k=28 link-sampling, ca-AstroPh k=20 link-sampling
(heldout 2%), assort-75-4 batch / rnode / stratified-rpair.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference"
BUILD = "/tmp/svinet_ref_build"
EXAMPLES = os.path.join(REF, "example")

OUR_ENV = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=REPO)

CONFIGS = {
    "lfr": {
        "desc": "LFR n=1000 k=28 link-sampling",
        "flags": ["-file", f"{EXAMPLES}/LFR-network-n1000-k28.txt",
                  "-n", "1000", "-k", "28", "-link-sampling",
                  "-nmi", f"{EXAMPLES}/LFR-ground-truth-n1000-k28.txt",
                  "-max-iterations", "200"],
        "metrics": ["nmi", "nshol"],
        "timeout": 1200,
    },
    "astro": {
        "desc": "ca-AstroPh n=17903 k=20 link-sampling, heldout 2%",
        "flags": ["-file", f"{EXAMPLES}/ca-AstroPh.csv",
                  "-n", "17903", "-k", "20", "-link-sampling",
                  "-heldout-ratio", "0.02", "-max-iterations", "200"],
        "metrics": ["nshol"],
        "timeout": 3600,
    },
    "assort-batch": {
        "desc": "assort-75-4 -batch",
        "flags": ["-file", f"{EXAMPLES}/assort-75-4.txt", "-n", "75",
                  "-k", "4", "-batch", "-max-iterations", "100"],
        "metrics": ["val"],
        "timeout": 600,
    },
    "assort-rnode": {
        "desc": "assort-75-4 -rnode",
        "flags": ["-file", f"{EXAMPLES}/assort-75-4.txt", "-n", "75",
                  "-k", "4", "-rnode", "-max-iterations", "100"],
        "metrics": ["val"],
        "timeout": 600,
    },
    "assort-srpair": {
        "desc": "assort-75-4 -stratified -rpair",
        "flags": ["-file", f"{EXAMPLES}/assort-75-4.txt", "-n", "75",
                  "-k", "4", "-stratified", "-rpair",
                  "-max-iterations", "100"],
        "metrics": ["val"],
        "timeout": 600,
    },
}


def build_reference(skip: bool = False) -> str:
    binary = os.path.join(BUILD, "svinet_ref")
    if skip and os.path.exists(binary):
        return binary
    print(f"+ building reference with the GSL shim -> {binary}")
    os.makedirs(BUILD, exist_ok=True)
    for name in os.listdir(os.path.join(REF, "src")):
        if name.endswith((".cc", ".hh")):
            shutil.copy(os.path.join(REF, "src", name), BUILD)
    subprocess.run(
        ["g++", "-std=gnu++11", "-fpermissive", "-O2", "-w", "-I.",
         "-I", os.path.join(REPO, "tools", "gslshim")]
        + sorted(f for f in os.listdir(BUILD) if f.endswith(".cc"))
        + ["-o", "svinet_ref", "-lpthread"],
        cwd=BUILD, check=True)
    return binary


def _run(cmd, cwd, timeout, env=None) -> bool:
    try:
        r = subprocess.run(cmd, cwd=cwd, timeout=timeout, env=env,
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.STDOUT)
        return r.returncode == 0
    except subprocess.TimeoutExpired:
        print(f"  ! timeout after {timeout}s: {' '.join(map(str, cmd[:4]))}")
        return False


def _outdir(scratch: str) -> str:
    dirs = [d for d in os.listdir(scratch)
            if os.path.isdir(os.path.join(scratch, d))]
    assert len(dirs) == 1, f"expected one output dir in {scratch}: {dirs}"
    return os.path.join(scratch, dirs[0])


def score(outdir: str, metrics) -> dict:
    out = {}
    if "nmi" in metrics:
        sys.path.insert(0, REPO)
        from svinet_tpu.evals.nmi import overlapping_nmi, read_cover_file
        ours = read_cover_file(os.path.join(outdir, "communities.txt"))
        gt = read_cover_file(os.path.join(outdir, "ground_truth.txt"))
        out["nmi"] = overlapping_nmi(gt, ours)
    if "nshol" in metrics:
        row = open(os.path.join(outdir, "max.txt")).read().split()
        out["nshol"] = float(row[4])   # best-so-far nshol
        out["iters"] = int(float(row[0]))
    if "val" in metrics:
        rows = [r for r in open(os.path.join(outdir, "validation.txt"))
                if r.strip()]
        out["val"] = float(rows[-1].split()[2])
    return out


def run_side(side: str, binary: str, cfg: dict, seed: int) -> dict:
    scratch = tempfile.mkdtemp(prefix=f"parity-{side}-")
    flags = cfg["flags"] + ["-seed", str(seed)]
    t0 = time.time()
    if side == "ref":
        ok = _run([binary] + flags, scratch, cfg["timeout"])
    else:
        ok = _run([sys.executable, "-m", "svinet_tpu"] + flags, scratch,
                  cfg["timeout"], env=OUR_ENV)
    if not ok:
        return {"error": "failed/timeout"}
    res = score(_outdir(scratch), cfg["metrics"])
    res["secs"] = round(time.time() - t0, 1)
    return res


def fmt(res: dict) -> str:
    if "error" in res:
        return res["error"]
    parts = []
    if "nmi" in res:
        parts.append(f"NMI {res['nmi']:.3f}")
    if "nshol" in res:
        parts.append(f"nshol {res['nshol']:.5f} @ {res['iters']}")
    if "val" in res:
        parts.append(f"val {res['val']:.3f}")
    parts.append(f"{res['secs']:.0f}s")
    return ", ".join(parts)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="seed 1 only, assort + LFR configs")
    ap.add_argument("--skip-build", action="store_true")
    ap.add_argument("--configs", default="",
                    help="comma list from: " + ",".join(CONFIGS))
    ap.add_argument("--seeds", default="")
    args = ap.parse_args()

    names = (args.configs.split(",") if args.configs
             else (["assort-batch", "lfr"] if args.quick
                   else list(CONFIGS)))
    seeds = ([int(s) for s in args.seeds.split(",")] if args.seeds
             else ([1] if args.quick else [1, 2, 3]))

    binary = build_reference(skip=args.skip_build)

    lines = ["# PARITY_RUN — regenerated by tools/parity_run.py", "",
             f"seeds: {seeds}; reference rebuilt with tools/gslshim "
             "(mt19937_64; statistical, not bitwise, parity).", "",
             "| Config | Side | " + " | ".join(f"seed {s}" for s in seeds)
             + " |",
             "|---|---|" + "---|" * len(seeds)]
    for name in names:
        cfg = CONFIGS[name]
        for side in ("ref", "ours"):
            row = []
            for seed in seeds:
                print(f"+ {name} seed {seed} [{side}] ...", flush=True)
                res = run_side(side, binary, cfg, seed)
                print(f"  -> {fmt(res)}", flush=True)
                row.append(fmt(res))
            lines.append(f"| {cfg['desc']} | {side} | " + " | ".join(row)
                         + " |")
    table = "\n".join(lines) + "\n"
    print("\n" + table)
    with open(os.path.join(REPO, "PARITY_RUN.md"), "w") as f:
        f.write(table)
    print(f"+ wrote {os.path.join(REPO, 'PARITY_RUN.md')}")


if __name__ == "__main__":
    main()
