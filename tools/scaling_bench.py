"""Scaling-efficiency harness for the sharded link-sampling sweep.

Measures sweep throughput at 1, 2, 4, ... devices on whatever mesh is
available (the GPUs of one host, or the virtual CPU mesh via
  JAX_PLATFORMS=cpu \
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python tools/scaling_bench.py)
and prints one JSON line per mesh size with the efficiency relative to
one device. The BASELINE target is >=0.8 efficiency on a 2-host slice.

NOTE: on the virtual CPU mesh every "device" shares the same physical
cores, so the efficiency numbers there only validate mechanics (the
collective layout compiles and runs); real scaling must be measured on
an actual multi-chip slice.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from svinet_tpu.parallel.mesh import (
    make_mesh, make_sharded_sweep, shard_edges, device_put_sharded_edges,
    device_put_replicated)
from svinet_tpu.svi.sweep_math import LSConsts


def run(n: int = 100_000, k: int = 32, n_edges: int = 2_000_000,
        iters: int = 20, block: int = 8192) -> None:
    rng = np.random.default_rng(0)
    p = rng.integers(0, n - 1, size=n_edges).astype(np.int32)
    q = rng.integers(1, n, size=n_edges).astype(np.int32)
    q = np.where(q <= p, p + 1, q).astype(np.int32)
    edges = np.stack([p, q], 1)
    deg = np.zeros(n, np.float32)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    gamma0 = rng.gamma(1.0, 1.0, (n, k)).astype(np.float32)
    lam0 = np.tile([1.0, 1.0], (k, 1)).astype(np.float32)

    n_avail = len(jax.devices())
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_avail]
    base_tp = None
    for nd in sizes:
        mesh = make_mesh(nd)
        es, ms = shard_edges(edges, nd, block)
        per_shard = es.shape[0] // nd
        sweep = make_sharded_sweep(mesh, per_shard // block)
        e_d, m_d = device_put_sharded_edges(mesh, es, ms)
        g_d, l_d, d_d = device_put_replicated(
            mesh, jnp.asarray(gamma0), jnp.asarray(lam0), jnp.asarray(deg))
        consts = LSConsts(*device_put_replicated(
            mesh, jnp.float32(1.0 / k), jnp.asarray([1.0, 1.0], jnp.float32),
            jnp.float32(n_edges), jnp.float32(n)))
        ann, = device_put_replicated(mesh, jnp.float32(1.0))
        g_d, l_d = sweep(g_d, l_d, e_d, m_d, d_d, consts, ann)
        jax.block_until_ready((g_d, l_d))
        t0 = time.perf_counter()
        for _ in range(iters):
            g_d, l_d = sweep(g_d, l_d, e_d, m_d, d_d, consts, ann)
        jax.block_until_ready((g_d, l_d))
        dt = time.perf_counter() - t0
        tp = iters * n_edges / dt
        if base_tp is None:
            base_tp = tp
        eff = tp / (base_tp * nd)
        print(json.dumps({
            "metric": "sharded_sweep_scaling", "devices": nd,
            "value": round(tp, 1), "unit": "edges/sec",
            "efficiency_vs_1dev": round(eff, 3)}))





def run_collective_share(n: int = 100_000, k: int = 32,
                         n_edges: int = 2_000_000, iters: int = 10,
                         block: int = 8192) -> None:
    """Empirical collective-vs-compute split per sharded sweep.

    Method: time the real sharded sweep (psum'd gacc/sumk/s1/s2/s3)
    against an ablated shard_map sweep with the collectives REMOVED
    (results numerically wrong, timing-only). The difference is the
    collective cost actually paid on this mesh. On the virtual CPU mesh
    collectives are shared-memory copies, so the ratio there says
    nothing about NVLink."""
    import functools
    from jax.sharding import PartitionSpec as P
    from svinet_tpu.svi.sweep_math import (
        phi_pass, mean_indicator_update, s3_pass, finish_lambda)
    from svinet_tpu.ops.expectations import dirichlet_expectation

    rng = np.random.default_rng(0)
    p = rng.integers(0, n - 1, size=n_edges).astype(np.int32)
    q = rng.integers(1, n, size=n_edges).astype(np.int32)
    q = np.where(q <= p, p + 1, q).astype(np.int32)
    edges = np.stack([p, q], 1)
    deg = np.zeros(n, np.float32)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    gamma0 = rng.gamma(1.0, 1.0, (n, k)).astype(np.float32)
    lam0 = np.tile([1.0, 1.0], (k, 1)).astype(np.float32)

    n_avail = len(jax.devices())
    for nd in [d for d in (2, 4, 8) if d <= n_avail]:
        mesh = make_mesh(nd)
        es, ms = shard_edges(edges, nd, block)
        per_shard = es.shape[0] // nd
        nb = per_shard // block
        e_d, m_d = device_put_sharded_edges(mesh, es, ms)
        g_d, l_d, d_d = device_put_replicated(
            mesh, jnp.asarray(gamma0), jnp.asarray(lam0), jnp.asarray(deg))
        consts = LSConsts(*device_put_replicated(
            mesh, jnp.float32(1.0 / k),
            jnp.asarray([1.0, 1.0], jnp.float32),
            jnp.float32(n_edges), jnp.float32(n)))
        ann, = device_put_replicated(mesh, jnp.float32(1.0))

        def local(with_psum):
            def _local(gamma, lam, edges, mask, deg, consts, annealing):
                elogpi = dirichlet_expectation(gamma)
                elogbeta = dirichlet_expectation(lam)
                gacc, sumk = phi_pass(elogpi, elogbeta[:, 0], edges,
                                      mask, nb)
                if with_psum:
                    gacc = jax.lax.psum(gacc, "edges")
                    sumk = jax.lax.psum(sumk, "edges")
                gnext, mphi, s1, s2, lam0_ = mean_indicator_update(
                    gacc, sumk, deg, consts, annealing)
                s3 = s3_pass(mphi, edges, mask, nb)
                if with_psum:
                    s3 = jax.lax.psum(s3, "edges")
                return gnext, finish_lambda(s1, s2, s3, lam0_, consts)
            sharded = jax.shard_map(
                _local, mesh=mesh,
                in_specs=(P(), P(), P("edges"), P("edges"), P(),
                          LSConsts(P(), P(), P(), P()), P()),
                out_specs=(P(), P()), check_vma=False)
            return jax.jit(sharded)

        times = {}
        for name, fn in (("full", local(True)), ("nocoll", local(False))):
            g, l = fn(g_d, l_d, e_d, m_d, d_d, consts, ann)
            jax.block_until_ready((g, l))
            t0 = time.perf_counter()
            g, l = g_d, l_d
            for _ in range(iters):
                g, l = fn(g, l, e_d, m_d, d_d, consts, ann)
            jax.block_until_ready((g, l))
            times[name] = (time.perf_counter() - t0) / iters
        share = max(0.0, 1.0 - times["nocoll"] / times["full"])
        print(json.dumps({
            "metric": "collective_share_per_sweep", "devices": nd,
            "t_full_s": round(times["full"], 4),
            "t_nocollective_s": round(times["nocoll"], 4),
            "collective_share": round(share, 4)}))


def run_rowshard_locality_share(n: int = 400_000, k: int = 64,
                                n_edges: int = 1_000_000,
                                cross_frac: float = 0.03,
                                iters: int = 5, block: int = 8192) -> None:
    """Empirical collective share of the ROW-SHARDED fused sweep, plain
    layout vs -mesh-locality, on a planted-partition graph (round-4
    review items 1 and 6: show the share drop the boundary-rows-only
    collectives buy, with the problem sized so even d=8 is above timing
    noise on the virtual mesh — n*K is large relative to E*K, the regime
    where the (n,K) collectives actually matter).

    Method per layout: time the full sweep against an ablated variant
    with the all_gather/psum_scatter removed (numerically wrong,
    timing-only); the difference is the collective cost paid."""
    import functools
    from jax.sharding import NamedSharding, PartitionSpec as P
    from svinet_tpu.config import Config
    from svinet_tpu.graph import Network
    from svinet_tpu.parallel.locality import locality_edge_layout
    from svinet_tpu.parallel.mesh import global_put
    from svinet_tpu.svi.sweep_math import (
        fused_phi_s3_pass, mean_indicator_update, finish_lambda)
    from svinet_tpu.ops.expectations import dirichlet_expectation

    rng = np.random.default_rng(0)
    nc = 200                      # planted communities
    csize = n // nc
    n_within = int(n_edges * (1.0 - cross_frac))
    base = rng.integers(0, nc, size=n_within) * csize
    p = base + rng.integers(0, csize, size=n_within)
    q = base + rng.integers(0, csize, size=n_within)
    pc = rng.integers(0, n, size=n_edges - n_within)
    qc = rng.integers(0, n, size=n_edges - n_within)
    p = np.concatenate([p, pc])
    q = np.concatenate([q, qc])
    shuf = rng.permutation(n)     # hide the planted layout
    p, q = shuf[p], shuf[q]
    cfg = Config(n=n, k=k, link_sampling=True, outdir="/tmp/locshare")
    cfg.resolve()
    net = Network(cfg)
    net.from_arrays(p, q)
    net.reorder_locality(8)
    edges = net.edges
    deg = np.zeros(n, np.float32)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    gamma0 = rng.gamma(1.0, 1.0, (n, k)).astype(np.float32)
    lam0 = np.tile([1.0, 1.0], (k, 1)).astype(np.float32)

    n_avail = len(jax.devices())
    for nd in [d for d in (2, 4, 8) if d <= n_avail and n % d == 0]:
        mesh = make_mesh(nd)
        row = NamedSharding(mesh, P("edges"))
        consts = LSConsts(*device_put_replicated(
            mesh, jnp.float32(1.0 / k),
            jnp.asarray([1.0, 1.0], jnp.float32),
            jnp.float32(len(edges)), jnp.float32(n)))
        ann, = device_put_replicated(mesh, jnp.float32(1.0))

        def build(layout, with_coll):
            if layout == "locality":
                le, lmask, exp_idx, info = locality_edge_layout(
                    edges, n, nd, block)
                nb = info["per_shard"] // block
                e_d, m_d = device_put_sharded_edges(mesh, le, lmask)
                exp_d = global_put(exp_idx, row)
            else:
                es, ms = shard_edges(edges, nd, block)
                nb = es.shape[0] // nd // block
                e_d, m_d = device_put_sharded_edges(mesh, es, ms)
                exp_d = global_put(np.zeros(nd, np.int32), row)
                info = None

            def _local(gamma, lam, mphi, edges_, mask_, deg_, exp_idx_,
                       consts_, annealing):
                local_rows = jnp.concatenate(
                    [dirichlet_expectation(gamma), mphi], axis=1)
                rows_per = local_rows.shape[0]
                if layout == "locality":
                    exports = jnp.take(local_rows, exp_idx_, axis=0,
                                       mode="clip")
                    if with_coll:
                        table = jax.lax.all_gather(exports, "edges",
                                                   tiled=True)
                    else:
                        table = jnp.tile(exports, (nd, 1))
                    packed = jnp.concatenate([local_rows, table], axis=0)
                else:
                    packed = (jax.lax.all_gather(local_rows, "edges",
                                                 tiled=True)
                              if with_coll
                              else jnp.tile(local_rows, (nd, 1)))
                elogbeta = dirichlet_expectation(lam)
                gacc_full, sumk, s3 = fused_phi_s3_pass(
                    packed, elogbeta[:, 0], edges_, mask_, nb)
                sumk = jax.lax.psum(sumk, "edges")
                s3 = jax.lax.psum(s3, "edges")
                if layout == "locality":
                    bnd = gacc_full[rows_per:]
                    if with_coll:
                        bnd = jax.lax.psum_scatter(
                            bnd, "edges", scatter_dimension=0, tiled=True)
                    else:
                        bnd = bnd[: bnd.shape[0] // nd]
                    gacc = gacc_full[:rows_per].at[exp_idx_].add(bnd)
                else:
                    gacc = (jax.lax.psum_scatter(
                        gacc_full, "edges", scatter_dimension=0,
                        tiled=True) if with_coll
                        else gacc_full[:gacc_full.shape[0] // nd])
                gnext, m_new, s1, s2, l0 = mean_indicator_update(
                    gacc, sumk, deg_, consts_, annealing)
                s1 = jax.lax.psum(s1, "edges")
                s2 = jax.lax.psum(s2, "edges")
                return gnext, finish_lambda(s1, s2, s3, l0,
                                            consts_), m_new

            sharded = jax.shard_map(
                _local, mesh=mesh,
                in_specs=(P("edges"), P(), P("edges"), P("edges"),
                          P("edges"), P("edges"), P("edges"),
                          LSConsts(P(), P(), P(), P()), P()),
                out_specs=(P("edges"), P(), P("edges")),
                check_vma=False)
            fn = jax.jit(sharded)
            args = (e_d, m_d, global_put(deg, row), exp_d, consts, ann)
            return fn, args, info

        out = {"metric": "rowshard_locality_collective_share",
               "devices": nd, "n": n, "k": k, "edges": len(edges)}
        for layout in ("rowshard", "locality"):
            fn, (e_d, m_d, d_d, exp_d, consts_, ann_), info = build(
                layout, True)
            fn0, _, _ = build(layout, False)
            times = {}
            for name, f in (("full", fn), ("nocoll", fn0)):
                g = global_put(gamma0, row)
                m = global_put(np.zeros_like(gamma0), row)
                l, = device_put_replicated(mesh, jnp.asarray(lam0))
                g, l, m = f(g, l, m, e_d, m_d, d_d, exp_d, consts_, ann_)
                jax.block_until_ready((g, l))
                t0 = time.perf_counter()
                for _ in range(iters):
                    g, l, m = f(g, l, m, e_d, m_d, d_d, exp_d, consts_,
                                ann_)
                jax.block_until_ready((g, l))
                times[name] = (time.perf_counter() - t0) / iters
            share = max(0.0, 1.0 - times["nocoll"] / times["full"])
            out[layout] = {"t_full_s": round(times["full"], 4),
                           "t_nocoll_s": round(times["nocoll"], 4),
                           "collective_share": round(share, 4)}
            if layout == "locality" and info is not None:
                out["table_frac"] = round(nd * info["xmax"] / n, 4)
                out["internal_frac"] = round(info["internal_frac"], 4)
        print(json.dumps(out))


if __name__ == "__main__":
    import sys
    if "--locality" in sys.argv:
        run_rowshard_locality_share()
    elif "--collectives" in sys.argv:
        run_collective_share()
    else:
        kwargs = {}
        if len(sys.argv) > 1:
            kwargs["n"] = int(sys.argv[1])
        run(**kwargs)
