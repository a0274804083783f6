"""Measure -fuse-s3 vs the default sweep at the stretch shape
(n=1M, K=500) on the device.

State is initialized on the device; timings end in block_until_ready.
Run one process per device:

    python tools/fuse_s3_bench.py [n k edges sweeps]

-fuse-s3 was a small gain on the accelerator the engine was first built
for; on the GPU it is to be measured again.
"""

from __future__ import annotations

import sys
import time

import numpy as np


def main(n: int = 1_000_000, k: int = 500, ne: int = 20_000_000,
         sweeps: int = 3) -> None:
    import jax
    import jax.numpy as jnp
    from svinet_tpu.ops.edges import pad_edges, choose_edge_block
    from svinet_tpu.svi.linksampling import (
        linksampling_multi_sweep, linksampling_fused_multi_sweep)
    from svinet_tpu.svi.sweep_math import LSConsts

    rng = np.random.default_rng(0)
    p = rng.integers(0, n - 1, size=ne).astype(np.int32)
    q = rng.integers(1, n, size=ne).astype(np.int32)
    q = np.where(q <= p, p + 1, q).astype(np.int32)
    edges = np.stack([p, q], 1)
    deg = np.zeros(n, np.float32)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    block = choose_edge_block(ne, k)
    ep, m = pad_edges(edges, block)
    nb = ep.shape[0] // block
    e_d, m_d, d_d = jnp.asarray(ep), jnp.asarray(m), jnp.asarray(deg)
    consts = LSConsts(jnp.float32(1.0 / k),
                      jnp.asarray([1.0, 1.0], jnp.float32),
                      jnp.float32(ne), jnp.float32(n))

    @jax.jit
    def init_state(key):
        # Gamma(1,1) == Exponential(1); jax.random.gamma's rejection
        # sampler needs ~30 GB of temps at (1M, 500)
        g = jax.random.exponential(key, (n, k), jnp.float32)
        l = jnp.ones((k, 2), jnp.float32)
        return g, l

    def timed(fn, nstate, label):
        st = list(init_state(jax.random.PRNGKey(0)))
        if nstate == 3:
            st.append(jnp.zeros((n, k), jnp.float32))
        # warm up with the SAME n_sweeps (fori_loop trip count is baked
        # into the program; a different count would recompile in the
        # timed region)
        out = fn(*st, e_d, m_d, d_d, consts, jnp.float32(1.0), nb,
                 sweeps)
        out = jax.block_until_ready(out)   # compile
        t0 = time.perf_counter()
        out = fn(*out, e_d, m_d, d_d, consts, jnp.float32(1.0), nb,
                 sweeps)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / sweeps
        print(f"{label}: {dt:.3f} s/sweep  {ne / dt / 1e6:.2f} Me/s")
        return dt

    t_u = timed(linksampling_multi_sweep, 2, "default sweep")
    t_f = timed(linksampling_fused_multi_sweep, 3, "-fuse-s3 sweep")
    print(f"speedup: {t_u / t_f:.3f}x")


if __name__ == "__main__":
    args = [int(x) for x in sys.argv[1:]]
    main(*args)
