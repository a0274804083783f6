"""Headline benchmark: LinkSampling SVI throughput on ca-AstroPh (k=20).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "edges/sec", "vs_baseline": N}

Baseline: the reference's bundled ca-AstroPh run
(/root/reference/example/n17903-k20-mmsb-linksampling.tgz) converged in
99 iterations x ~190k training links in 77 s on a single 2013-era CPU core
=> ~244k edge phi-updates/sec (BASELINE.md). vs_baseline = ours / 244e3.
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

DATA = "/root/reference/example/ca-AstroPh.csv"
BASELINE_EDGES_PER_SEC = 99 * 193031 / 77.0  # ~248k phi-updates(edges)/s


def synth_main(n: int, k: int, n_edges: int, emit: bool = True,
               fused: bool = False, bf16: bool = False) -> dict:
    """Stretch benchmark: synthetic MMSB-scale sweep (BASELINE.json's
    n=1M/k=500 config). Random planted edges; measures raw sweep
    throughput at a size no single 2013 CPU core could touch.
    fused=True measures the -fuse-s3 sweep. State is initialized on the
    device: no (n, K) host array is built or uploaded."""
    from svinet_tpu.ops.edges import pad_edges
    from svinet_tpu.svi.linksampling import (
        linksampling_sweep, linksampling_fused_multi_sweep)
    from svinet_tpu.svi.sweep_math import LSConsts

    rng = np.random.default_rng(0)
    p = rng.integers(0, n - 1, size=n_edges).astype(np.int32)
    q = rng.integers(1, n, size=n_edges).astype(np.int32)
    q = np.where(q <= p, p + 1, q).astype(np.int32)
    edges = np.stack([p, q], 1)
    deg = np.zeros(n, np.float32)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    from svinet_tpu.ops.edges import choose_edge_block
    block = choose_edge_block(n_edges, k)
    edges_p, mask = pad_edges(edges, block)
    nb = edges_p.shape[0] // block

    @jax.jit
    def _init(key):
        # Gamma(1,1) == Exponential(1) (jax.random.gamma's rejection
        # sampler needs ~30 GB of temps at this shape)
        return (jax.random.exponential(key, (n, k), jnp.float32),
                jnp.ones((k, 2), jnp.float32))

    gamma, lam = _init(jax.random.PRNGKey(0))
    consts = LSConsts(alpha=jnp.float32(1.0 / k),
                      eta=jnp.asarray([1.0, 1.0], jnp.float32),
                      ones=jnp.float32(n_edges), n_nodes=jnp.float32(n))
    e_d, m_d, d_d = (jnp.asarray(edges_p), jnp.asarray(mask),
                     jnp.asarray(deg))
    ann = jnp.float32(1.0)
    iters = 5
    if fused:
        mphi = jnp.zeros((n, k), jnp.float32)
        state = jax.block_until_ready(linksampling_fused_multi_sweep(
            gamma, lam, mphi, e_d, m_d, d_d, consts, ann, nb, iters,
            bf16))
        t0 = time.perf_counter()
        jax.block_until_ready(linksampling_fused_multi_sweep(
            *state, e_d, m_d, d_d, consts, ann, nb, iters, bf16))
    else:
        gamma, lam = jax.block_until_ready(linksampling_sweep(
            gamma, lam, e_d, m_d, d_d, consts, ann, nb, False, bf16))
        t0 = time.perf_counter()
        for _ in range(iters):
            gamma, lam = linksampling_sweep(gamma, lam, e_d, m_d, d_d,
                                            consts, ann, nb, False, bf16)
        jax.block_until_ready((gamma, lam))
    dt = time.perf_counter() - t0
    eps = iters * n_edges / dt
    rec = {
        "metric": (f"linksampling_edges_per_sec_synth_n{n}_k{k}"
                   + ("_fused_s3" if fused else "")
                   + ("_bf16" if bf16 else "")),
        "value": round(eps, 1),
        "unit": "edges/sec",
        "vs_baseline": round(eps / BASELINE_EDGES_PER_SEC, 3),
    }
    if emit:
        print(json.dumps(rec))
    return rec


def main() -> None:
    from svinet_tpu.config import Config
    from svinet_tpu.graph import Network
    from svinet_tpu.ops.edges import pad_edges
    from svinet_tpu.svi.linksampling import (
        linksampling_multi_sweep, init_gamma_from_links)
    from svinet_tpu.svi.sweep_math import LSConsts

    cfg = Config(n=17903, k=20, heldout_ratio=0.02, link_sampling=True,
                 outdir="/tmp/svinet-bench")
    cfg.resolve()
    net = Network(cfg)
    net.read(DATA)
    rng = np.random.default_rng(0)
    net.sample_heldout_sets(rng)

    from svinet_tpu.ops.edges import choose_edge_block
    n, k = net.n, cfg.k
    block = choose_edge_block(len(net.training_links), cfg.k)
    edges_p, mask = pad_edges(net.training_links, block)
    num_blocks = edges_p.shape[0] // block
    edges_d = jnp.asarray(edges_p)
    mask_d = jnp.asarray(mask)
    deg_d = jnp.asarray(net.training_deg.astype(np.float32))
    gamma = jnp.asarray(
        init_gamma_from_links(rng, net.edges, n, k, cfg.alpha), jnp.float32)
    lam = jnp.asarray(np.tile([cfg.eta0, cfg.eta1], (k, 1)), jnp.float32)
    consts = LSConsts(alpha=jnp.float32(cfg.alpha),
                      eta=jnp.asarray([cfg.eta0, cfg.eta1], jnp.float32),
                      ones=jnp.float32(net.ones),
                      n_nodes=jnp.float32(n))
    ann = jnp.float32(1.0)

    # The engine fuses all sweeps between report boundaries into ONE device
    # program (linksampling_multi_sweep, the CLI's -rfreq behavior), so the
    # benchmark measures exactly that: rfreq sweeps per host round trip.
    rfreq = 10

    # warmup / compile
    gamma, lam = jax.block_until_ready(linksampling_multi_sweep(
        gamma, lam, edges_d, mask_d, deg_d, consts, ann, num_blocks, rfreq))

    n_dispatch = 20
    t0 = time.perf_counter()
    for _ in range(n_dispatch):
        gamma, lam = linksampling_multi_sweep(gamma, lam, edges_d, mask_d,
                                              deg_d, consts, ann,
                                              num_blocks, rfreq)
    jax.block_until_ready((gamma, lam))
    dt = time.perf_counter() - t0
    n_iters = n_dispatch * rfreq

    n_train = len(net.training_links)
    eps = n_iters * n_train / dt

    # -fuse-s3 variant of the same headline config, recorded alongside,
    # NOT as the headline: the headline stays the default path
    from svinet_tpu.svi.linksampling import linksampling_fused_multi_sweep
    gf = jnp.asarray(
        init_gamma_from_links(np.random.default_rng(0), net.edges,
                              n, k, cfg.alpha), jnp.float32)
    lf = jnp.asarray(np.tile([cfg.eta0, cfg.eta1], (k, 1)), jnp.float32)
    mf = jnp.zeros((n, k), jnp.float32)
    state = jax.block_until_ready(linksampling_fused_multi_sweep(
        gf, lf, mf, edges_d, mask_d, deg_d, consts, ann, num_blocks, rfreq))
    t0 = time.perf_counter()
    for _ in range(n_dispatch):
        state = linksampling_fused_multi_sweep(
            *state, edges_d, mask_d, deg_d, consts, ann, num_blocks, rfreq)
    jax.block_until_ready(state)
    eps_fused = n_iters * n_train / (time.perf_counter() - t0)
    fused_rec = {"value": round(eps_fused, 1),
                 "vs_baseline": round(eps_fused / BASELINE_EDGES_PER_SEC, 3)}

    # the n=1M/k=500 stretch sweep in the same record
    stretch = synth_main(1_000_000, 500, 20_000_000, emit=False)
    stretch_fused = synth_main(1_000_000, 500, 20_000_000, emit=False,
                               fused=True)
    stretch_bf16 = synth_main(1_000_000, 500, 20_000_000, emit=False,
                              fused=True, bf16=True)
    d = jax.devices()[0]
    print(json.dumps({
        "metric": "linksampling_edges_per_sec_ca-AstroPh_k20",
        "value": round(eps, 1),
        "unit": "edges/sec",
        "vs_baseline": round(eps / BASELINE_EDGES_PER_SEC, 3),
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
        "fused_s3": fused_rec,
        "stretch": stretch,
        "stretch_fused_s3": stretch_fused,
        "stretch_fused_s3_bf16": stretch_bf16,
    }))


def _require_gpu() -> None:
    """Times are device metrics: refuse to time anything but a GPU, and
    turn on the persistent compile cache before the first compile."""
    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"bench.py times the GPU; JAX's first device is "
                         f"{jax.devices()[0].platform!r}")
    from svinet_tpu.cli import configure_compile_cache
    configure_compile_cache()


if __name__ == "__main__":
    import sys
    _require_gpu()
    if len(sys.argv) > 1 and sys.argv[1] == "--synth":
        n = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000_000
        k = int(sys.argv[3]) if len(sys.argv) > 3 else 500
        e = int(sys.argv[4]) if len(sys.argv) > 4 else 20_000_000
        synth_main(n, k, e, fused="--fused" in sys.argv,
                   bf16="--bf16" in sys.argv)
    else:
        main()
