"""Dense-vs-sparse sweep crossover at huge K (round-4 VERDICT item 3).

The reference's active-community pruning wins in the per-NODE sparse
regime (phi over the union of the endpoints' active lists,
src/linksampling.cc:634-664). `-sparse-w W` is its static-shape form
(svi/sweep_math.py:sparse_union_sweep_body): dense (n,K) state, O(W)
edge pass via flat gathers + a per-edge union sort + (node, column)
scatter-adds. This harness measures raw sweep throughput of the dense
fused sweep vs the sparse union sweep on ca-AstroPh at K in
{500, 2000, 8000} (5-10x+ overshoot of the true ~20 communities) — the
crossover table the -prune story needs.

Timings end in block_until_ready; multi-sweep programs are warmed with
the SAME n_sweeps they time. The dense sweep won everywhere on the
accelerator the engine was first built for; on the GPU the crossover is
to be measured again.

Usage: python tools/sparse_crossover.py   (on the GPU)
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

N_SWEEPS = 3
REPS = 3
KS = tuple(int(x) for x in
           os.environ.get("CROSSOVER_KS", "500,2000,8000").split(","))


def main() -> None:
    from svinet_tpu.config import Config
    from svinet_tpu.graph import Network
    from svinet_tpu.ops.edges import pad_edges, choose_edge_block
    from svinet_tpu.svi.sweep_math import LSConsts
    from svinet_tpu.svi.linksampling import (
        linksampling_fused_multi_sweep, linksampling_sparse_multi_sweep)

    cfg = Config(n=17903, k=20, link_sampling=True,
                 outdir="/tmp/crossover")
    cfg.resolve()
    net = Network(cfg)
    net.read("/root/reference/example/ca-AstroPh.csv")
    E = net.ones
    rng = np.random.default_rng(0)
    deg = np.zeros(net.n, np.float32)
    np.add.at(deg, net.edges[:, 0], 1)
    np.add.at(deg, net.edges[:, 1], 1)
    deg_d = jnp.asarray(deg)

    rows = []
    for K in KS:
        block = choose_edge_block(E, K)
        ep, mask = pad_edges(net.edges, block)
        nb = ep.shape[0] // block
        ep_d, mask_d = jnp.asarray(ep), jnp.asarray(mask)
        consts = LSConsts(jnp.float32(1.0 / K),
                          jnp.asarray([1.0, 1.0], jnp.float32),
                          jnp.float32(E), jnp.float32(net.n))
        ann = jnp.float32(0.0)
        z = jnp.zeros(1, jnp.float32)

        def fresh():
            g = jnp.asarray(
                rng.gamma(1.0, 1.0, (net.n, K)).astype(np.float32))
            l = jnp.asarray(np.tile([1.0, 1.0], (K, 1)).astype(np.float32))
            m = jnp.zeros((net.n, K), jnp.float32)
            return g, l, m

        def run(label, fn):
            g, l, m = fresh()
            g, l, m = fn(g, l, m)
            jax.block_until_ready((g, l, m))
            times = []
            for _r in range(REPS):
                t0 = time.perf_counter()
                g, l, m = fn(g, l, m)
                jax.block_until_ready((g, l, m))
                times.append(time.perf_counter() - t0)
            dt = min(times)
            meps = N_SWEEPS * E / dt / 1e6
            print(f"  {label}: {dt:.3f}s / {N_SWEEPS} sweeps "
                  f"= {meps:.2f} M edge-updates/s", flush=True)
            return meps

        print(f"K={K} (block {block}, {nb} blocks):", flush=True)
        row = {"K": K, "E": E}
        row["dense_fused"] = run(
            "dense fused", lambda g, l, m: linksampling_fused_multi_sweep(
                g, l, m, ep_d, mask_d, deg_d, consts, ann, nb, N_SWEEPS))
        for W in (32, 64, 128):
            if W >= K:
                continue
            row[f"sparse_w{W}"] = run(
                f"sparse W={W}",
                lambda g, l, m, W=W: linksampling_sparse_multi_sweep(
                    g, l, m, ep_d, mask_d, deg_d, consts, ann,
                    z, z, z, jnp.float32(1e-30), nb, N_SWEEPS, W, 0))
        rows.append(row)
        print(json.dumps(row), flush=True)

    print(json.dumps({"metric": "sparse_union_crossover_astroph",
                      "rows": rows}))


if __name__ == "__main__":
    main()
