"""FastInit width-cap study on ca-AstroPh (round-1 VERDICT Weak #6).

The reference sizes each node's sparse label slots by the max degree
(src/main.cc:321-327); svi/fastinit.py caps the width at 64 to bound the
O(width^2) overlap tensors. This harness runs -findk on ca-AstroPh
(max degree 504) at widths 32/64/128/256/504 and tabulates the estimated
K (line count of communities.txt), the heldout nshol, and the wall time,
so the README can record whether the cap moves K-hat.

Usage: python tools/findk_width_study.py [--widths 32,64,...] [--cpu]
Runs are serial (one JAX process on the device at a time).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = "/root/reference/example"


def run_one(width: int, cpu: bool, seed: int) -> dict:
    wd = tempfile.mkdtemp(prefix=f"findkw-{width}-")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    if cpu:
        env["JAX_PLATFORMS"] = "cpu"
    cmd = [sys.executable, "-m", "svinet_tpu", "-file",
           f"{EX}/ca-AstroPh.csv", "-n", "17903", "-k", "20", "-findk",
           "-findk-width", str(width), "-seed", str(seed),
           "-label", f"w{width}"]
    t0 = time.time()
    subprocess.run(cmd, cwd=wd, env=env, check=True, capture_output=True,
                   timeout=7200)
    dt = time.time() - t0
    out = next(p for p in os.listdir(wd)
               if os.path.isdir(os.path.join(wd, p)))
    od = os.path.join(wd, out)
    with open(os.path.join(od, "communities.txt")) as f:
        khat = sum(1 for line in f if line.strip())
    with open(os.path.join(od, "max.txt")) as f:
        best_nshol = float(f.read().split()[4])
    return {"width": width, "khat": khat, "best_nshol": best_nshol,
            "secs": round(dt, 1)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", default="32,64,128,256,504")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    rows = []
    for w in (int(x) for x in args.widths.split(",")):
        rows.append(run_one(w, args.cpu, args.seed))
        print(f"done: width {w} -> K^ {rows[-1]['khat']}", file=sys.stderr)
    print("| width | K-hat | best nshol | secs |")
    print("|---|---|---|---|")
    for r in rows:
        print(f"| {r['width']} | {r['khat']} | {r['best_nshol']:.5f} "
              f"| {r['secs']} |")


if __name__ == "__main__":
    main()
